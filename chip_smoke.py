"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one line before the last:
  1. device: require CUDA, print the card's name and power limit
     (nvidia-smi), apply and check the strict fp32 precision policy;
  2. build: build (or load) the mac_kmajor kernel from its source;
  3. kernel: mac_kmajor against its plain PyTorch version on the card at the
     slice's shapes (single-block K=520 R=40 O=4, and 3 accumulated pages
     R=32 O=32, B=16384), with max-abs and rel-RMS errors and CUDA-event
     times of both;
  4. bake: models.bake.bake at full width (B=16384 streams, S=2, T=512, a
     synthetic 4320-tap HRIR bank, a 10-filter EQ) over 32 blocks with
     blocks_per_step=8 (the main path) and 1; the outputs are finite and
     non-silent, the two modes agree, 4 sampled lanes match a float64
     reference (scipy fftconvolve then sosfilt), and the kernel's launch
     count rose in both modes;
  5. timing: the paged chain on device-resident input for 192 blocks, as
     bench.py:measure times the JAX chain (for the record only);
then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Needs no network; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from airwave_tpu_torch.device import apply_precision_policy, precision_is_strict
from airwave_tpu_torch.kernels import mac_kmajor as mk
from airwave_tpu_torch.models.bake import bake
from airwave_tpu_torch.models.binaural import BinauralChain, ChainState
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import eq_block, upols

SAMPLE_RATE = 48_000.0
BATCH, SPEAKERS, EARS, BLOCK, HRIR_TAPS = 16384, 2, 2, 512, 4320
BLOCKS_PER_STEP = 8
BAKE_BLOCKS = 32
TIMED_BLOCKS = 192
KERNEL_TOL = 1e-6   # rel-RMS, kernel vs plain version (fp32 reassociation)
CHAIN_TOL = 1e-5    # rel-RMS, the BASELINE.md chain contract
KERNEL_SOURCE = "airwave_tpu_torch/kernels/csrc/mac_kmajor.cu"
KERNEL_REPLACES = "airwave_tpu/kernels/mac_kmajor.py:66"


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def rel_rms(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over `reps` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_eq():
    """bench.py:_finish_build's 10-filter EQ."""
    kinds = (bd.FilterType.PEAKING, bd.FilterType.LOW_SHELF,
             bd.FilterType.HIGH_SHELF)
    filters = tuple(
        bd.EqualizerFilter(i + 1, i + 1, True, kinds[i % 3],
                           100.0 * (i + 1) + 60.0, (-1.0) ** i * 2.0, 0.9)
        for i in range(10)
    )
    return bd.design_cascade(bd.EqualizerDefinition(-2.5, filters),
                             SAMPLE_RATE)


def device_phase() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    apply_precision_policy()
    if not precision_is_strict():
        raise RuntimeError("strict fp32 precision policy not in effect")
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda,
          allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          matmul_precision=torch.get_float32_matmul_precision())
    return smi


def build_phase() -> None:
    t0 = time.perf_counter()
    log = mk.build()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    phase("build", seconds=seconds, ptxas=ptxas)


def kernel_phase(rng: np.random.Generator, dev: torch.device) -> list:
    """The kernel against its plain version at the slice's two shapes, both
    also against a float64 evaluation of the same contraction."""
    Kp = upols.padded_bin_count(BLOCK)
    cases = []

    def tensor(shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=dev)

    # Single-block step: R = S * P2 * 2 with P2 = 10 (9 partitions + 1).
    fdl, h = tensor((Kp, 40, BATCH)), tensor((Kp, 4, 40))
    pages = [tensor((Kp, 32, BATCH)) for _ in range(3)]
    hp = [tensor((Kp, 32, 32)) for _ in range(3)]

    def paged_kernel():
        acc = mk.mac_kmajor(pages[0], hp[0])
        for p, q in zip(pages[1:], hp[1:]):
            mk.mac_kmajor(p, q, out=acc, accumulate=True)
        return acc

    def paged_plain():
        acc = mk.mac_kmajor_ref(pages[0], hp[0])
        for p, q in zip(pages[1:], hp[1:]):
            acc = acc + mk.mac_kmajor_ref(p, q)
        return acc

    def paged_exact():
        return sum(mk.mac_kmajor_ref(p.double(), q.double())
                   for p, q in zip(pages, hp))

    for name, kern, plain, exact_fn in (
        ("single_block K=520 R=40 O=4 B=16384",
         lambda: mk.mac_kmajor(fdl, h), lambda: mk.mac_kmajor_ref(fdl, h),
         lambda: mk.mac_kmajor_ref(fdl.double(), h.double())),
        ("paged 3 pages K=520 R=32 O=32 B=16384", paged_kernel, paged_plain,
         paged_exact),
    ):
        got, ref = kern().double(), plain().double()
        exact = exact_fn()
        diff = got - ref
        max_abs = diff.abs().max().item()
        rel = (diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
        scale = exact.pow(2).mean().sqrt()
        rel_exact = ((got - exact).pow(2).mean().sqrt() / scale).item()
        plain_rel_exact = ((ref - exact).pow(2).mean().sqrt() / scale).item()
        del got, ref, exact, diff
        case = dict(case=name, max_abs_err=max_abs, rel_rms=rel,
                    rel_rms_vs_fp64=rel_exact,
                    plain_rel_rms_vs_fp64=plain_rel_exact,
                    ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 20))
        phase("kernel", **case)
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: rel-RMS {rel} > {KERNEL_TOL}")
        cases.append(case)
    return cases


def reference_lanes(hrir, x, lanes, preamp, coeffs):
    """float64 reference of the chain for the given lanes: per speaker and
    ear fftconvolve, summed over speakers, then the EQ cascade (sosfilt of
    the port's design_cascade coefficients, preamp first)."""
    from scipy.signal import fftconvolve, sosfilt

    n = x.shape[-1]
    sos = np.array([[c.b0, c.b1, c.b2, 1.0, c.a1, c.a2] for c in coeffs])
    out = np.zeros((len(lanes), EARS, n))
    for i, b in enumerate(lanes):
        for e in range(EARS):
            dry = sum(fftconvolve(x[b, s].astype(np.float64),
                                  hrir[s, e].astype(np.float64))[:n]
                      for s in range(SPEAKERS))
            out[i, e] = sosfilt(sos, preamp * dry)
    return out


def bake_phase(rng: np.random.Generator, dev: torch.device) -> dict:
    hrir = (rng.standard_normal((SPEAKERS, EARS, HRIR_TAPS)) * 0.05).astype(
        np.float32)
    hrir[:, :, 0] += 0.8
    preamp, coeffs = bench_eq()
    x = rng.standard_normal((BATCH, SPEAKERS, BAKE_BLOCKS * BLOCK),
                            dtype=np.float32)
    x *= 0.25
    lanes = sorted(int(b) for b in rng.choice(BATCH, 4, replace=False))
    ref = reference_lanes(hrir, x, lanes, preamp, coeffs)

    outs, launches = {}, {}
    for M in (BLOCKS_PER_STEP, 1):
        mk.reset_launch_count()
        t0 = time.perf_counter()
        y, state = bake(hrir, x, SAMPLE_RATE, coeffs, preamp,
                        block_size=BLOCK, blocks_per_step=M, device=dev)
        seconds = time.perf_counter() - t0
        launches[M] = mk.launch_count()
        del state
        finite = bool(np.isfinite(y).all())
        rms = float(np.sqrt(np.mean(np.square(y, dtype=np.float64))))
        lane_err = [rel_rms(y[b], ref[i]) for i, b in enumerate(lanes)]
        phase("bake", blocks_per_step=M, seconds=seconds, shape=list(y.shape),
              finite=finite, rms=rms, launches=launches[M], lanes=lanes,
              lane_rel_rms=lane_err)
        if not (finite and rms > 0):
            raise AssertionError(f"M={M}: output not finite or silent")
        if not max(lane_err) <= CHAIN_TOL:
            raise AssertionError(f"M={M}: lane rel-RMS {lane_err} > {CHAIN_TOL}")
        if launches[M] <= 0:
            raise AssertionError(f"M={M}: mac_kmajor was not launched")
        outs[M] = y
    modes = rel_rms(outs[BLOCKS_PER_STEP], outs[1])
    phase("bake_modes", rel_rms=modes)
    if not modes <= CHAIN_TOL:
        raise AssertionError(f"M=8 vs M=1 rel-RMS {modes} > {CHAIN_TOL}")
    return launches


def timing_phase(seed: int, dev: torch.device, smi: str) -> None:
    """The paged chain at B=16384, M=8 on device-resident input, 192 blocks
    per call with a checksum fetched to the host (bench.py:measure's
    pattern: one warm-up call, best of 3)."""
    M = BLOCKS_PER_STEP
    rng = np.random.default_rng(seed)
    hrir = (rng.standard_normal((SPEAKERS, EARS, HRIR_TAPS)) * 0.05).astype(
        np.float32)
    hrir[:, :, 0] += 0.8
    preamp, coeffs = bench_eq()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        conv_params = upols.make_conv_params(hrir, BLOCK, pad_to_pow2=False,
                                             lookahead=M, device=dev)
        eq = eq_block.make_eq_params(coeffs, preamp, BLOCK, device=dev)
        chain = BinauralChain(conv_params, eq, eq, 960, BLOCK,
                              blocks_per_step=M)
        state = ChainState(
            conv=upols.make_conv_state_paged(
                BATCH, SPEAKERS, conv_params.partition_count, BLOCK, M, dev),
            eq=eq_block.make_eq_state(BATCH, device=dev),
        )
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((BATCH, SPEAKERS, M, BLOCK), generator=gen,
                        device=dev) * 0.25

        def run(state):
            acc = torch.zeros((8, 128), device=dev)
            for _ in range(TIMED_BLOCKS // M):
                state, y = chain(state, x)
                acc += y.reshape(-1, 8, 128).sum(0)
            return state, acc.cpu().numpy()

        state, warm = run(state)
        if not np.isfinite(warm).all():
            raise AssertionError("non-finite timing checksum")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state, host = run(state)
            best = min(best, time.perf_counter() - t0)
            if not np.isfinite(host).all():
                raise AssertionError("non-finite timing checksum")
    audio_seconds = BATCH * TIMED_BLOCKS * BLOCK / SAMPLE_RATE
    phase("timing", card=smi, batch=BATCH, blocks_per_step=M,
          blocks=TIMED_BLOCKS, n_pages=len(state.conv.pages),
          ms_per_block_step=best / TIMED_BLOCKS * 1e3,
          x_realtime=audio_seconds / best,
          peak_memory_bytes=torch.cuda.max_memory_allocated())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    rng = np.random.default_rng(args.seed)
    cases = kernel_phase(rng, dev)
    launches = bake_phase(rng, dev)
    timing_phase(args.seed, dev, smi)

    main_case = cases[1]
    print(json.dumps({"kernels": [{
        "name": "mac_kmajor", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches[BLOCKS_PER_STEP],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "cases": cases,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
