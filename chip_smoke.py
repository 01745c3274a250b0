"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one line before the last:
  1. device: require CUDA, print the card's name and power limit
     (nvidia-smi), apply and check the strict fp32 precision policy;
  2. build: build the library of both MAC kernels, mac_kmajor and
     mac_kmajor_pages (one nvcc, its ptxas registers and spills printed), and
     the native frame assembler (g++) from their sources, both at once;
  3. kernel: each kernel against its plain PyTorch version on the card at the
     paths' shapes (mac_kmajor: single-block K=520 R=40 O=4 at B=16384 and
     at the ring pool's B=8192, and 3 pages R=32 O=32 at B=16384 summed by
     three launches with `accumulate`; mac_kmajor_pages: the same 3 pages in
     one launch, and 13 pages R=128 at B=2048), with errors against the
     plain version and float64, CUDA-event times of the kernel, the plain
     version and the one PyTorch call of the same function, and the bound
     from bytes and FLOPs; the fused kernel is timed in turns with the three
     launches (three, fused, fused, three) and equals them bit for bit; the
     hot-swap rounds' dual-bank shapes (mac_kmajor at O=8, B=8192 and
     16384; mac_kmajor_pages at O=64) are timed in turns with the routes
     the dispatch took before it had them (the generic kernel, 16 columns
     per pass), which they equal bit for bit;
  4. bake: models.bake.bake at full width (B=16384 streams, S=2, T=512, a
     synthetic 4320-tap HRIR bank, a 10-filter EQ) over 32 blocks with
     blocks_per_step=8 and 1; the outputs are finite and non-silent, the two
     modes agree, 4 sampled lanes match a float64 reference (scipy
     fftconvolve then sosfilt), and each mode launched its kernel once per
     step (mac_kmajor_pages at M=8, mac_kmajor at M=1) and not the other;
  5. timing: the paged chain on device-resident input for 192 blocks, as
     bench.py:measure times the JAX chain, then one 8-block step alone in
     CUDA-event time with its kernels from torch.profiler (for the record
     only);
  6. pool: the serving pool's ring tier (StreamPool, 8192 lanes, 48 kHz)
     from a synthetic 14-channel HRIR WAV written and loaded back by the
     port's io.wav, through prepare_renderer, with the 10-filter EQ; 48
     rounds of ragged traffic (each lane fed with probability 0.75, so the
     masked step runs and lanes rejoin with debt), then full rounds
     (ring_all with one lane detached, ring_id after it re-attaches); 4
     sampled lanes within 1e-5 of float64, mac_kmajor launched once per
     round, debt rolls run;
  7. pool_paged: the same at blocks_per_step=8 on 16384 lanes, with
     mac_kmajor_pages launched once per round;
  8. pool_timing (after each tier): every lane fed one step per round
     (push_many, pump(max_rounds=1), pull_many), 64 blocks per lane per
     reading, best of 3 after two warm-up rounds; x_realtime, ms per round
     and its push/pump/pull split, peak device memory, and the CUDA-event
     time of one saturated device round alone with its kernels from
     torch.profiler (for the record only);
  9. pool_retarget: a 64-lane pool on the card and the same pool on the CPU
     (plain versions) fed the same ragged traffic with three EQ retargets
     and a detach and re-attach; every stream agrees within 1e-5, for both
     tiers;
 10. hotswap_engine: BinauralEngine at 16384 lanes, two crossfaded swaps
     (the second while the first fade is pending), 4 sampled lanes within
     1e-5 of a float64 time-varying reference, fade blocks launching
     mac_kmajor at O=8 and steady blocks at O=4;
 11. hotswap_pool, hotswap_pool_paged: both pool tiers at full width with
     ragged traffic, a swap mid-stream and a lane paused across it (on the
     paged tier a second swap to a bank of fewer partitions, padded onto
     the carry); the same reference check, one MAC launch per round at the
     dual-bank O in fade rounds (8, 64) and the steady O otherwise, and the
     CUDA-event time of one steady and one fade device round;
 12. checkpoint: snapshot() mid-traffic on both tiers, restored into a fresh
     pool that then delivers the same audio as the uninterrupted one, bit
     for bit; on the ring tier also a restore(..., resize=True) into 4096
     lanes after half the lanes detach; the snapshot's bytes and seconds;
then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Needs no network; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from airwave_tpu_torch import native
from airwave_tpu_torch.assets import channel_maps
from airwave_tpu_torch.device import apply_precision_policy, precision_is_strict
from airwave_tpu_torch.graph.renderer import (build_hrir_time_domain,
                                              prepare_renderer)
from airwave_tpu_torch.io import wav as wavio
from airwave_tpu_torch.kernels import mac_kmajor as mk
from airwave_tpu_torch.models.bake import bake
from airwave_tpu_torch.models.binaural import (BinauralChain, BinauralEngine,
                                               ChainOperands, ChainState,
                                               chain_step_fn,
                                               make_chain_operands)
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import eq_block, upols
from airwave_tpu_torch.runtime.stream_pool import StreamPool, pool_step_body

SAMPLE_RATE = 48_000.0
BATCH, SPEAKERS, EARS, BLOCK, HRIR_TAPS = 16384, 2, 2, 512, 4320
BLOCKS_PER_STEP = 8
BAKE_BLOCKS = 32
TIMED_BLOCKS = 192
LONG_BANK = (13, 8, 2048)   # pages, speakers, lanes of the long-bank MAC case
KERNEL_TOL = 1e-6   # rel-RMS, kernel vs plain version (fp32 reassociation)
CHAIN_TOL = 1e-5    # rel-RMS, the BASELINE.md chain contract
KERNEL_SOURCE = "airwave_tpu_torch/kernels/csrc/mac_kmajor.cu"
KERNEL_REPLACES = "airwave_tpu/kernels/mac_kmajor.py:66"
# The TPU kernel's paged use, the JAX step's _paged_mac, is what
# mac_kmajor_pages replaces.
PAGED_MAC_FUNCTION = "airwave_tpu/ops/upols.py:689"
KERNELS = ("mac_kmajor", "mac_kmajor_pages")
# The H100's published peaks (NVIDIA data sheet, SXM, at 700 W): HBM bytes
# per second, and fp32 FLOP/s outside the tensor cores (the kernel's type).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

HRIR_CHANNELS = 14          # a HeSuVi 14-channel bank, as the assets ship
EQ_RAMP = 960               # the 20 ms EQ crossfade at 48 kHz, in samples
POOL_LANES = {1: 8192, BLOCKS_PER_STEP: 16384}    # ring tier, paged tier
POOL_ROUNDS = {1: (48, 8), BLOCKS_PER_STEP: (6, 4)}  # (ragged, full) rounds
POOL_SHARE = 0.75           # chance that a lane is fed in a ragged round
POOL_TIMED_BLOCKS = 64      # blocks per lane per timing reading
RETARGET_LANES = 64
SHORT_TAPS = 2000           # the shorter bank of the paged tier's second swap
ENGINE_BLOCKS = (8, 1, 7)   # engine: blocks before swap 1, to swap 2, after
# Hot-swap traffic per tier: "r" a ragged round, "f" every lane fed, an int
# a swap to that bank; and the rounds in which the paused lane is not fed.
HOTSWAP_SCHEDULE = {
    1: (["r"] * 6 + [1] + ["r"] * 6 + ["f"] * 2, range(4, 8)),
    BLOCKS_PER_STEP: (["r"] * 3 + [1] + ["r"] * 3 + ["f", 2] + ["r"] * 2
                      + ["f"] * 2, range(1, 5)),
}
CHECKPOINT_ROUNDS = {1: (4, 6), BLOCKS_PER_STEP: (2, 3)}  # (before, after)
RESIZE_LANES = POOL_LANES[1] // 2


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


def device_breakdown(fn, reps: int = 3, top: int = 8):
    """Device time of fn() from torch.profiler, in ms per call over `reps`
    calls: the total, the `top` kernels, and the `top` aten ops with their
    input shapes (a kernel launched through ctypes, as mac_kmajor is, has
    no aten op and shows among the kernels only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages(group_by_input_shape=True)

    def rows(device_type, label):
        return sorted(((e.self_device_time_total / 1e3 / reps, label(e))
                       for e in events if e.device_type == device_type
                       and e.self_device_time_total > 0), reverse=True)

    kernels = rows(DeviceType.CUDA, lambda e: e.key[:80])
    ops = rows(DeviceType.CPU, lambda e: f"{e.key} {e.input_shapes}")
    return (sum(t for t, _ in kernels),
            [[name, t] for t, name in kernels[:top]],
            [[name, t] for t, name in ops[:top]])


def bench_eq_definition(scale: float = 1.0) -> bd.EqualizerDefinition:
    """bench.py:_finish_build's 10-filter EQ, its gains times `scale`."""
    kinds = (bd.FilterType.PEAKING, bd.FilterType.LOW_SHELF,
             bd.FilterType.HIGH_SHELF)
    filters = tuple(
        bd.EqualizerFilter(i + 1, i + 1, True, kinds[i % 3],
                           100.0 * (i + 1) + 60.0,
                           (-1.0) ** i * 2.0 * scale, 0.9)
        for i in range(10)
    )
    return bd.EqualizerDefinition(-2.5, filters)


def bench_eq():
    """(preamp, coefficients) of bench_eq_definition()."""
    return bd.design_cascade(bench_eq_definition(), SAMPLE_RATE)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or fp32
    FLOPs over the fp32 peak, whichever is larger."""
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return dict(bound_ms=max(by_bytes, by_flops) * 1e3,
                bound_by="bytes" if by_bytes >= by_flops else "operations")


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
    """nvcc of the kernel and g++ of the assembler, started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kernel = pool.submit(mk.build)
        assembler = pool.submit(native.load_library)
        log = kernel.result()
        assembler.result()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if any(w in ln for w in ("entry function", "registers", "spill"))]
    phase("build", seconds=seconds, ptxas=ptxas)


def kernel_phase(rng: np.random.Generator, dev: torch.device) -> list:
    """Each kernel against its plain version at the paths' shapes, both also
    against a float64 evaluation of the same contraction, and the one
    PyTorch call that computes the same function (library_ms). The fused
    paged kernel is also timed in turns with the sum of one mac_kmajor
    launch per page that it replaces (three launches at the headline
    shape), and must equal that sum bit for bit."""
    Kp = upols.padded_bin_count(BLOCK)
    cases = []

    def tensor(shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=dev)

    def measure(kernel, name, kern, plain, exact_fn, library, bnd, ms=None,
                **extra):
        got, ref = kern().double(), plain().double()
        exact = exact_fn()
        diff = got - ref
        max_abs = diff.abs().max().item()
        rel = (diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
        scale = exact.pow(2).mean().sqrt()
        rel_exact = ((got - exact).pow(2).mean().sqrt() / scale).item()
        plain_rel_exact = ((ref - exact).pow(2).mean().sqrt() / scale).item()
        library_rel = ((library().double() - exact).pow(2).mean().sqrt()
                       / scale).item()
        del got, ref, exact, diff
        case = dict(kernel=kernel, case=name, max_abs_err=max_abs,
                    rel_rms=rel, rel_rms_vs_fp64=rel_exact,
                    plain_rel_rms_vs_fp64=plain_rel_exact,
                    library_rel_rms_vs_fp64=library_rel,
                    ms=cuda_ms(kern, 20) if ms is None else ms,
                    plain_ms=cuda_ms(plain, 20),
                    library_ms=cuda_ms(library, 20), **bnd, **extra)
        phase("kernel", **case)
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: rel-RMS {rel} > {KERNEL_TOL}")
        cases.append(case)
        torch.cuda.empty_cache()

    for B in (BATCH, POOL_LANES[1]):
        # R = S * P2 * 2 with P2 = 10 (9 partitions + 1), O = E * 2.
        fdl, h = tensor((Kp, 40, B)), tensor((Kp, EARS * 2, 40))
        measure("mac_kmajor", f"single_block K={Kp} R=40 O=4 B={B}",
                lambda: mk.mac_kmajor(fdl, h), lambda: mk.mac_kmajor_ref(fdl, h),
                lambda: mk.mac_kmajor_ref(fdl.double(), h.double()),
                lambda: torch.einsum("krb,kor->okb", fdl, h),
                bound(4 * (fdl.numel() + h.numel() + 4 * Kp * B),
                      2 * Kp * 40 * 4 * B))
        del fdl, h

    # Pages R = S*2*M, O = M*E*2 at M = 8: the headline's 3 pages at S = 2,
    # and a long 8-speaker bank, whose page bank is 16 KB per bin.
    M = BLOCKS_PER_STEP
    n_long, s_long, b_long = LONG_BANK
    for n, R, B in ((3, SPEAKERS * 2 * M, BATCH), (n_long, s_long * 2 * M, b_long)):
        O = M * EARS * 2
        pages = [tensor((Kp, R, B)) for _ in range(n)]
        bank = tensor((n, Kp, O, R))
        stacked = torch.stack(pages)  # for the one library call only

        def per_page():
            acc = mk.mac_kmajor(pages[0], bank[0])
            for p, h in zip(pages[1:], bank[1:]):
                mk.mac_kmajor(p, h, out=acc, accumulate=True)
            return acc

        def fused():
            return mk.mac_kmajor_pages(pages, bank)

        shape = f"{n} pages K={Kp} R={R} O={O} B={B}"
        equal = torch.equal(fused(), per_page())
        diff = (fused() - per_page()).abs().max().item()
        # In turns: per-page launches, fused, fused, per-page launches.
        turns = [cuda_ms(f, 20) for f in (per_page, fused, fused, per_page)]
        args = (lambda: mk.mac_kmajor_pages_ref(pages, bank),
                lambda: sum(mk.mac_kmajor_ref(p.double(), h.double())
                            for p, h in zip(pages, bank)),
                lambda: torch.einsum("pkrb,pkor->okb", stacked, bank),
                bound(4 * (n * Kp * R * B + bank.numel() + O * Kp * B),
                      2 * n * Kp * R * O * B))
        if n == 3:
            measure("mac_kmajor", f"paged {shape}", per_page, *args)
        measure("mac_kmajor_pages", f"paged fused {shape}", fused, *args,
                ms=(turns[1] + turns[2]) / 2, ms_turns=turns[1:3],
                per_page_launches_ms=(turns[0] + turns[3]) / 2,
                per_page_launches_ms_turns=[turns[0], turns[3]],
                equals_per_page_launches=equal,
                max_abs_diff_per_page_launches=diff)
        if not equal:
            raise AssertionError(f"{shape}: the fused kernel differs from one "
                                 f"launch per page by up to {diff}")
        del pages, bank, stacked
        torch.cuda.empty_cache()

    # A hot-swap round's dual bank doubles the output columns: O = 8 for the
    # single block (the ring pool at 8192 lanes, the engine at 16384) and
    # O = 64 for the paged round. Each is timed in turns with the route the
    # dispatch took before it had these shapes (the generic kernel; 16
    # columns per pass over the pages), which it must equal bit for bit.
    def dual(kernel, shape, new, old, args):
        equal, diff = torch.equal(new(), old()), (new() - old()).abs().max().item()
        turns = [cuda_ms(f, 20) for f in (old, new, new, old)]
        equal_plain = torch.equal(new(), args[0]())
        measure(kernel, f"dual bank {shape}", new, *args,
                ms=(turns[1] + turns[2]) / 2, ms_turns=turns[1:3],
                previous_route_ms=(turns[0] + turns[3]) / 2,
                previous_route_ms_turns=[turns[0], turns[3]],
                equals_previous_route=equal,
                max_abs_diff_previous_route=diff, equals_plain=equal_plain)
        if not equal:
            raise AssertionError(f"{shape}: the dual-bank route differs from "
                                 f"the previous route by up to {diff}")

    R, O = 40, 2 * EARS * 2
    for B in (POOL_LANES[1], BATCH):
        fdl, h = tensor((Kp, R, B)), tensor((Kp, O, R))
        dual("mac_kmajor", f"single_block K={Kp} R={R} O={O} B={B}",
             lambda: mk.mac_kmajor(fdl, h),
             lambda: mk.mac_kmajor(fdl, h, generic=True),
             (lambda: mk.mac_kmajor_ref(fdl, h),
              lambda: mk.mac_kmajor_ref(fdl.double(), h.double()),
              lambda: torch.einsum("krb,kor->okb", fdl, h),
              bound(4 * (fdl.numel() + h.numel() + O * Kp * B),
                    2 * Kp * R * O * B)))
        del fdl, h
        torch.cuda.empty_cache()
    n, R, O = 3, SPEAKERS * 2 * M, M * 2 * EARS * 2
    pages = [tensor((Kp, R, BATCH)) for _ in range(n)]
    bank = tensor((n, Kp, O, R))
    stacked = torch.stack(pages)
    dual("mac_kmajor_pages", f"{n} pages K={Kp} R={R} O={O} B={BATCH}",
         lambda: mk.mac_kmajor_pages(pages, bank),
         lambda: mk.mac_kmajor_pages(pages, bank, columns=16),
         (lambda: mk.mac_kmajor_pages_ref(pages, bank),
          lambda: sum(mk.mac_kmajor_ref(p.double(), h.double())
                      for p, h in zip(pages, bank)),
          lambda: torch.einsum("pkrb,pkor->okb", stacked, bank),
          bound(4 * (n * Kp * R * BATCH + bank.numel() + O * Kp * BATCH),
                2 * n * Kp * R * O * BATCH)))
    del pages, bank, stacked
    torch.cuda.empty_cache()
    return cases


def reference_lane(hrir, x, preamp, coeffs):
    """float64 reference of the chain for one lane's input x [S, n]: per
    speaker and ear fftconvolve, summed over speakers, then the EQ cascade
    (sosfilt of the port's design_cascade coefficients, preamp first)."""
    return reference_blend([hrir], [np.ones(x.shape[-1])], x, preamp, coeffs)


def reference_blend(banks, weights, x, preamp, coeffs):
    """float64 reference of one lane through a time-varying bank: the
    per-sample blend sum_i weights[i] * (banks[i] * x) of full-history
    convolutions (scipy fftconvolve), then the EQ cascade (sosfilt)."""
    from scipy.signal import fftconvolve, sosfilt

    n = x.shape[-1]
    sos = np.array([[c.b0, c.b1, c.b2, 1.0, c.a1, c.a2] for c in coeffs])
    out = np.zeros((EARS, n))
    for e in range(EARS):
        dry = sum(w * sum(fftconvolve(x[s].astype(np.float64),
                                          h[s, e].astype(np.float64))[:n]
                              for s in range(SPEAKERS))
                  for h, w in zip(banks, weights) if w.any())
        out[e] = sosfilt(sos, preamp * dry)
    return out


def fade_weights(n_banks: int, n: int, events) -> np.ndarray:
    """Per-sample weights [n_banks, n] of one lane's output: bank 0 until
    the first event, then for each (start, from, to, fade), in order, a
    ramp (t - start + 1) / fade from `from` to `to`, clipped at 1."""
    w = np.zeros((n_banks, n))
    w[0] = 1.0
    for start, frm, to, fade in events:
        r = np.minimum((np.arange(n - start) + 1.0) / fade, 1.0)
        w[:, start:] = 0.0
        w[frm, start:] += 1.0 - r
        w[to, start:] += r
    return w


def reference_lanes(hrir, x, lanes, preamp, coeffs):
    return np.stack([reference_lane(hrir, x[b], preamp, coeffs)
                     for b in lanes])


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
        launches[M] = {name: mk.launch_count(name) for name in KERNELS}
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
        used = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
        expected = {name: BAKE_BLOCKS // M if name == used else 0
                    for name in KERNELS}
        if launches[M] != expected:
            raise AssertionError(f"M={M}: launches {launches[M]}, expected "
                                 f"{expected} (one per step)")
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
        peak = torch.cuda.max_memory_allocated()

        def one_step():
            nonlocal state
            state, _ = chain(state, x)

        step_ms = cuda_ms(one_step, 10)
        profiled_ms, kernels, ops = device_breakdown(one_step)
    audio_seconds = BATCH * TIMED_BLOCKS * BLOCK / SAMPLE_RATE
    phase("timing", card=smi, batch=BATCH, blocks_per_step=M,
          blocks=TIMED_BLOCKS, n_pages=len(state.conv.pages),
          ms_per_block_step=best / TIMED_BLOCKS * 1e3,
          x_realtime=audio_seconds / best, peak_memory_bytes=peak,
          device_step_ms=step_ms, device_step_profiled_ms=profiled_ms,
          device_step_top_kernels=kernels, device_step_top_ops=ops)


def hrir_wav(seed: int, directory: str, taps: int = HRIR_TAPS) -> wavio.WAVData:
    """A seeded synthetic 14-channel HRIR bank of `taps` frames, written as a
    WAV file by the port's io.wav and loaded back: the renderer's asset
    path."""
    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((HRIR_CHANNELS, taps)) * 0.05).astype(
        np.float32)
    bank[:, 0] += 0.8
    path = os.path.join(directory, f"hrir14-{seed}.wav")
    wavio.save(path, bank, SAMPLE_RATE)
    return wavio.load(path)


def make_pool(wav, lanes: int, M: int, device, definition) -> StreamPool:
    renderer = prepare_renderer(wav, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                lookahead=M, device=device)
    return StreamPool(lanes, SAMPLE_RATE, renderer, eq_definition=definition,
                      block_size=BLOCK, blocks_per_step=M, device=device)


def feed_round(pool: StreamPool, lanes: np.ndarray, chunks: np.ndarray):
    """One round: a step of input to each of `lanes` (ascending), one pump
    round, and the rendered step of each of them pulled: [k, E, frames]."""
    pool.push_many(lanes, chunks)
    rounds = pool.pump()
    if rounds != 1:
        raise AssertionError(f"pump ran {rounds} rounds, expected 1")
    return pool.pull_many(lanes, pool.step_frames)


def settle(pool: StreamPool) -> None:
    """Run the construction-time unity -> target EQ ramp to its end on
    silence: afterwards every lane starts from zero history at the target,
    which the float64 reference assumes."""
    lanes = np.arange(pool.max_streams)
    zeros = np.zeros((len(lanes), SPEAKERS, pool.step_frames), np.float32)
    for _ in range(-(-EQ_RAMP // pool.step_frames) + 1):
        feed_round(pool, lanes, zeros)


def pool_phase(label: str, wav, dev: torch.device, M: int,
               rng: np.random.Generator):
    """The pool at full width on ragged then full traffic; 4 sampled lanes
    against float64. Returns (pool, one step of input per lane, launches)."""
    lanes = POOL_LANES[M]
    ragged, full = POOL_ROUNDS[M]
    preamp, coeffs = bench_eq()
    hrir = build_hrir_time_domain(wav, channel_maps.STEREO, SAMPLE_RATE)
    t0 = time.perf_counter()
    pool = make_pool(wav, lanes, M, dev, bench_eq_definition())
    every = np.array([pool.attach() for _ in range(lanes)])
    pool.prewarm()
    settle(pool)
    setup = time.perf_counter() - t0
    step = pool.step_frames
    base = rng.standard_normal((lanes, SPEAKERS, step), dtype=np.float32)
    base *= 0.25
    sampled = sorted(int(b) for b in rng.choice(np.arange(1, lanes), 4,
                                                 replace=False))
    inputs = {b: [] for b in sampled}
    outputs = {b: [] for b in sampled}

    def run(fed):
        y = feed_round(pool, fed, base[:len(fed)])
        for b in sampled:
            pos = int(np.searchsorted(fed, b))
            if pos < len(fed) and fed[pos] == b:
                inputs[b].append(base[pos])
                outputs[b].append(y[pos])

    mk.reset_launch_count()
    t0 = time.perf_counter()
    for _ in range(ragged):
        run(np.nonzero(rng.random(lanes) < POOL_SHARE)[0])
    pool.detach(0)  # every attached lane fed: the "_all" variant
    for _ in range(full // 2):
        run(every[1:])
    if pool.attach() != 0:
        raise AssertionError("lane 0 was not recycled")
    for _ in range(full - full // 2):  # every lane fed: the "_id" variant
        run(every)
    seconds = time.perf_counter() - t0
    launches = {name: mk.launch_count(name) for name in KERNELS}
    stats = pool.stats()
    lane_err = [rel_rms(np.concatenate(outputs[b], -1),
                        reference_lane(hrir, np.concatenate(inputs[b], -1),
                                       preamp, coeffs))
                for b in sampled]
    tier = "ring" if M == 1 else "paged"
    phase(label, lanes=lanes, blocks_per_step=M, setup_seconds=setup,
          seconds=seconds, rounds=ragged + full, launches=launches,
          debt_rolls=stats["debt_rolls"],
          variant_rounds=stats["variant_rounds"], lanes_sampled=sampled,
          lane_blocks=[len(inputs[b]) * M for b in sampled],
          lane_rel_rms=lane_err)
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"{label}: lane rel-RMS {lane_err} > {CHAIN_TOL}")
    used = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    expected = {name: ragged + full if name == used else 0 for name in KERNELS}
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expected} (one per round)")
    if stats["debt_rolls"] <= 0:
        raise AssertionError(f"{label}: no debt roll ran")
    want = {tier, f"{tier}_all", f"{tier}_id"}
    if not want <= set(stats["variant_rounds"]) or stats["render_errors"]:
        raise AssertionError(f"{label}: variants {stats['variant_rounds']}, "
                             f"errors {stats['render_errors']}")
    return pool, base, launches


def pool_timing_phase(pool: StreamPool, base: np.ndarray, smi: str) -> None:
    """bench.py:measure_pool_host's pattern: every lane fed one step per
    round (push_many, pump(max_rounds=1), pull_many), POOL_TIMED_BLOCKS
    blocks per lane per reading, best of 3 after two warm-up rounds. Then
    one saturated device round alone (the "_id" step on device-resident
    input), in CUDA-event time (for the record only)."""
    lanes = np.arange(pool.max_streams)
    M, step = pool.blocks_per_step, pool.step_frames
    rounds = POOL_TIMED_BLOCKS // M

    def one_round(split):
        t0 = time.perf_counter()
        pool.push_many(lanes, base)
        t1 = time.perf_counter()
        pool.pump(max_rounds=1)
        t2 = time.perf_counter()
        pool.pull_many(lanes, step)
        split += (t1 - t0, t2 - t1, time.perf_counter() - t2)

    for _ in range(2):
        one_round(np.zeros(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best, best_split = float("inf"), None
    for _ in range(3):
        split = np.zeros(3)
        t0 = time.perf_counter()
        for _ in range(rounds):
            one_round(split)
        wall = time.perf_counter() - t0
        if wall < best:
            best, best_split = wall, split
    peak = torch.cuda.max_memory_allocated()

    variant = "ring_id" if M == 1 else "paged_id"
    p = pool.eq_runtime.active.params
    operands = pool._operands(p)
    with torch.inference_mode():
        state = pool._fresh_state()
        x = torch.from_numpy(base).to(pool.device)
        if M > 1:
            x = x.view(len(lanes), SPEAKERS, M, BLOCK)
        idx = torch.arange(len(lanes), device=pool.device)

        def device_round():
            nonlocal state
            state, _ = pool_step_body(
                pool._conv_params, p, p, state, x, idx,
                pool.eq_runtime.transition_length, True, False, variant,
                operands)

        device_ms = cuda_ms(device_round, 10)
        profiled_ms, kernels, ops = device_breakdown(device_round)
    round_ms = best / rounds * 1e3
    phase("pool_timing", card=smi, lanes=len(lanes), blocks_per_step=M,
          rounds=rounds, x_realtime=len(lanes) * rounds * step / SAMPLE_RATE
          / best, ms_per_round=round_ms, ms_per_block=round_ms / M,
          push_ms_per_round=best_split[0] / rounds * 1e3,
          pump_ms_per_round=best_split[1] / rounds * 1e3,
          pull_ms_per_round=best_split[2] / rounds * 1e3,
          device_round_variant=variant, device_round_ms=device_ms,
          host_share=1.0 - device_ms / round_ms, peak_memory_bytes=peak,
          device_round_profiled_ms=profiled_ms,
          device_round_top_kernels=kernels, device_round_top_ops=ops)


def pool_retarget_phase(wav, dev: torch.device, rng: np.random.Generator):
    """A pool on the card and the same pool on the CPU, fed the same ragged
    traffic with three EQ retargets and a detach and re-attach: every
    stream agrees within CHAIN_TOL, on both tiers."""
    definitions = [bench_eq_definition(g) for g in (1.0, 0.5, -1.0, 1.5)]
    lanes, detached = RETARGET_LANES, 5
    for M in (1, BLOCKS_PER_STEP):
        pools = [make_pool(wav, lanes, M, d, definitions[0])
                 for d in (dev, torch.device("cpu"))]
        for pool in pools:
            for _ in range(lanes):
                pool.attach()
        step = pools[0].step_frames
        gap = -(-EQ_RAMP // step) + 2  # rounds from one retarget to the next
        retargets = {1 + gap * i: definitions[i] for i in (1, 2, 3)}
        outs = [[[] for _ in range(lanes)] for _ in pools]
        for rnd in range(1 + 4 * gap):
            if rnd in retargets:
                for pool in pools:
                    pool.set_equalizer(retargets[rnd])
            if rnd == gap + 1:
                for pool in pools:
                    pool.detach(detached)
            if rnd == gap + 3:
                for pool in pools:
                    if pool.attach() != detached:
                        raise AssertionError("lane was not recycled")
            fed = rng.random(lanes) < POOL_SHARE
            if gap + 1 <= rnd < gap + 3:
                fed[detached] = False
            fed = np.nonzero(fed)[0]
            chunks = rng.standard_normal((len(fed), SPEAKERS, step),
                                         dtype=np.float32) * 0.25
            for pool, out in zip(pools, outs):
                y = feed_round(pool, fed, chunks)
                for j, lane in enumerate(fed):
                    out[lane].append(y[j])
        err = [rel_rms(np.concatenate(a, -1), np.concatenate(b, -1))
               for a, b in zip(*outs)]
        rts = [pool.eq_runtime for pool in pools]
        stats = pools[0].stats()
        phase("pool_retarget", lanes=lanes, blocks_per_step=M,
              rounds=1 + 4 * gap, retarget_rounds=sorted(retargets),
              max_stream_rel_rms=max(err), debt_rolls=stats["debt_rolls"],
              variant_rounds=stats["variant_rounds"])
        if not max(err) <= CHAIN_TOL:
            raise AssertionError(f"card vs CPU rel-RMS {max(err)} > "
                                 f"{CHAIN_TOL} (M={M})")
        for rt in rts:
            if (rt.active.definition != definitions[-1]
                    or rt.is_transitioning or rt.pending_target is not None):
                raise AssertionError(f"the third retarget did not land "
                                     f"(M={M})")


def launches_now() -> dict:
    """Each kernel's launch count and its launches by output width O."""
    return {name: {"total": mk.launch_count(name),
                   **{f"O={o}": mk.launch_count(name, columns=o)
                      for o in (4, 8, 32, 64)
                      if mk.launch_count(name, columns=o)}}
            for name in KERNELS}


def engine_hotswap_phase(wavs, dev: torch.device, rng: np.random.Generator,
                         smi: str) -> dict:
    """BinauralEngine(16384 lanes) with the 10-filter EQ: ENGINE_BLOCKS[0]
    blocks, a crossfaded swap, ENGINE_BLOCKS[1] block, a second swap while
    the first fade is still pending (a restart from the lerped bank), then
    ENGINE_BLOCKS[2] blocks. 4 sampled lanes against the float64
    time-varying reference; each fade block one mac_kmajor launch at O = 8,
    each steady block one at O = 4; then one steady and one fade block alone
    in CUDA-event time."""
    renderers = [prepare_renderer(w, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                  device=dev) for w in wavs]
    banks = [build_hrir_time_domain(w, channel_maps.STEREO, SAMPLE_RATE)
             for w in wavs]
    preamp, coeffs = bench_eq()
    eng = BinauralEngine(BATCH, SAMPLE_RATE, BLOCK, renderer=renderers[0],
                         device=dev)
    eng.prepare_equalizer(bench_eq_definition())
    zeros = np.zeros((BATCH, SPEAKERS, BLOCK), np.float32)
    for _ in range(-(-EQ_RAMP // BLOCK) + 1):  # the EQ's unity ramp ends
        eng.process_block(zeros)
    sampled = sorted(int(b) for b in rng.choice(BATCH, 4, replace=False))
    before, between, after = ENGINE_BLOCKS
    swaps = {before: 1, before + between: 2}
    xs, ys = [], []
    mk.reset_launch_count()
    t0 = time.perf_counter()
    for b in range(before + between + after):
        if b in swaps and not eng.set_renderer(renderers[swaps[b]]):
            raise AssertionError(f"engine swap at block {b} did not crossfade")
        x = rng.standard_normal((BATCH, SPEAKERS, BLOCK), dtype=np.float32)
        x *= 0.25
        ys.append(eng.process_block(x)[sampled])
        xs.append(x[sampled])
    seconds = time.perf_counter() - t0
    launches = launches_now()
    fade = eng.config.transition_length(SAMPLE_RATE)
    n, t1, t2 = len(xs) * BLOCK, before * BLOCK, (before + between) * BLOCK
    r1 = np.minimum((np.arange(n) - t1 + 1.0) / fade, 1.0).clip(0.0)
    r2 = np.minimum((np.arange(n) - t2 + 1.0) / fade, 1.0).clip(0.0)
    r0 = min((t2 - t1 + 1.0) / fade, 1.0)  # where the restart freezes fade 1
    weights = np.stack([1.0 - r1, r1, np.zeros(n)])
    weights[:, t2:] = np.stack([(1.0 - r2) * (1.0 - r0), (1.0 - r2) * r0,
                                r2])[:, t2:]
    x_lane, y_lane = np.concatenate(xs, -1), np.concatenate(ys, -1)
    lane_err = [rel_rms(y_lane[i], reference_blend(banks, weights, x_lane[i],
                                                   preamp, coeffs))
                for i in range(len(sampled))]
    fade_blocks = min(between + -(-fade // BLOCK), len(xs) - before)
    expected = {"mac_kmajor": {"total": len(xs), "O=4": len(xs) - fade_blocks,
                               "O=8": fade_blocks},
                "mac_kmajor_pages": {"total": 0}}

    with torch.inference_mode():
        state = ChainState(
            upols.make_conv_state(BATCH, SPEAKERS, eng._conv_params.partition_count,
                                  BLOCK, dev),
            eq_block.make_eq_state(BATCH, device=dev))
        x_dev = torch.from_numpy(zeros).to(dev).normal_(0.0, 0.25)
        p = eng.eq_runtime.active.params
        dual = upols.xfade_conv_params(eng._conv_params, eng._conv_params)
        dual_ops = make_chain_operands(dual, None, 1, eng._k_padded)
        ramp = torch.from_numpy(upols.xfade_ramp(fade, BLOCK)).to(dev)
        tl = eng.eq_runtime.transition_length
        steady_ms = cuda_ms(lambda: chain_step_fn(
            eng._conv_params, p, p, state, x_dev, tl, True, True, False,
            eng._operands), 10)
        fade_ms = cuda_ms(lambda: chain_step_fn(
            dual, p, p, state, x_dev, tl, True, True, False, dual_ops,
            xfade_ramp=ramp), 10)
    phase("hotswap_engine", card=smi, lanes=BATCH, blocks=len(xs),
          swap_blocks=sorted(swaps), seconds=seconds, launches=launches,
          lanes_sampled=sampled, lane_rel_rms=lane_err,
          steady_block_device_ms=steady_ms, fade_block_device_ms=fade_ms)
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"engine hot-swap: lane rel-RMS {lane_err} > "
                             f"{CHAIN_TOL}")
    if launches != expected:
        raise AssertionError(f"engine hot-swap: launches {launches}, expected "
                             f"{expected}")
    return launches


class LaneRecorder:
    """Sampled lanes of a pool, round by round: their inputs and outputs,
    and their hot-swap fades on each lane's own output timeline as the pool
    runs them. A swap arms every attached lane; an armed lane fades in its
    next rendered round, from the bank it was armed from (on a second swap
    before that round, the newer old half: the JAX pool's semantics) to the
    newest."""

    def __init__(self, lanes, step: int):
        self.lanes, self.step = lanes, step
        self.inputs = {b: [] for b in lanes}
        self.outputs = {b: [] for b in lanes}
        self.current = {b: 0 for b in lanes}
        self.armed = {b: None for b in lanes}
        self.events = {b: [] for b in lanes}

    def swap(self, to: int, fade: int) -> None:
        for b in self.lanes:
            frm = self.armed[b][1] if self.armed[b] else self.current[b]
            self.armed[b] = (frm, to, fade)

    def record(self, fed: np.ndarray, chunks: np.ndarray, y: np.ndarray):
        for b in self.lanes:
            pos = int(np.searchsorted(fed, b))
            if pos == len(fed) or fed[pos] != b:
                continue
            if self.armed[b]:
                frm, to, fade = self.armed[b]
                self.events[b].append((len(self.inputs[b]) * self.step, frm,
                                       to, fade))
                self.current[b], self.armed[b] = to, None
            self.inputs[b].append(chunks[pos])
            self.outputs[b].append(y[pos])

    def errors(self, banks, preamp, coeffs) -> list:
        err = []
        for b in self.lanes:
            x = np.concatenate(self.inputs[b], -1)
            w = fade_weights(len(banks), x.shape[-1], self.events[b])
            err.append(rel_rms(np.concatenate(self.outputs[b], -1),
                               reference_blend(banks, w, x, preamp, coeffs)))
        return err


def pool_hotswap_phase(label: str, wavs, dev: torch.device, M: int,
                       rng: np.random.Generator, smi: str) -> dict:
    """A pool at full width through HOTSWAP_SCHEDULE[M]: ragged traffic,
    crossfaded swaps (on the paged tier a second one to a bank of fewer
    partitions, padded onto the carry), one sampled lane paused across the
    first swap that rejoins with alignment debt and fades then. 4 sampled
    lanes against the float64 time-varying reference; every round one MAC
    launch, at twice the steady O in a fade round (O = 8 ring, 64 paged) and
    at the steady O (4, 32) otherwise; then one steady and one fade device
    round alone in CUDA-event time, the fade round's aten ops from
    torch.profiler."""
    lanes = POOL_LANES[M]
    schedule, paused_rounds = HOTSWAP_SCHEDULE[M]
    renderers = [prepare_renderer(w, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                  lookahead=M, device=dev) for w in wavs]
    banks = [build_hrir_time_domain(w, channel_maps.STEREO, SAMPLE_RATE)
             for w in wavs]
    preamp, coeffs = bench_eq()
    pool = StreamPool(lanes, SAMPLE_RATE, renderers[0],
                      eq_definition=bench_eq_definition(), block_size=BLOCK,
                      blocks_per_step=M, device=dev)
    every = np.array([pool.attach() for _ in range(lanes)])
    t0 = time.perf_counter()
    pool.prewarm(include_hotswap=True)
    prewarm_seconds = time.perf_counter() - t0
    settle(pool)
    step = pool.step_frames
    fade = min(pool.config.transition_length(SAMPLE_RATE), step)
    sampled = sorted(int(b) for b in rng.choice(lanes, 4, replace=False))
    paused = sampled[0]
    rec = LaneRecorder(sampled, step)
    name = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    steady_o, dual_o = (EARS * 2, 2 * EARS * 2) if M == 1 else (
        M * EARS * 2, 2 * M * EARS * 2)
    round_kinds, carry = [], []
    mk.reset_launch_count()
    t0 = time.perf_counter()
    rnd = 0
    for item in schedule:
        if not isinstance(item, str):
            if not pool.set_renderer(renderers[item]):
                raise AssertionError(f"{label}: swap to bank {item} reset")
            rec.swap(item, fade)
            carry.append([pool._bank_partitions,
                          renderers[item].partition_count, pool._lane_cycle])
            continue
        fed = every if item == "f" else np.nonzero(
            rng.random(lanes) < POOL_SHARE)[0]
        if rnd in paused_rounds:
            fed = fed[fed != paused]
        chunks = rng.standard_normal((len(fed), SPEAKERS, step),
                                     dtype=np.float32) * 0.25
        fades, before = pool.fade_rounds, launches_now()[name]
        rec.record(fed, chunks, feed_round(pool, fed, chunks))
        after = launches_now()[name]
        kind = "fade" if pool.fade_rounds > fades else "steady"
        want_o = dual_o if kind == "fade" else steady_o
        if (after["total"] - before["total"] != 1
                or after.get(f"O={want_o}", 0) - before.get(f"O={want_o}", 0) != 1):
            raise AssertionError(f"{label}: round {rnd} ({kind}) launched "
                                 f"{before} -> {after}, expected one {name} "
                                 f"at O={want_o}")
        round_kinds.append(kind)
        rnd += 1
    seconds = time.perf_counter() - t0
    launches = launches_now()
    stats = pool.stats()
    lane_err = rec.errors(banks, preamp, coeffs)

    variant = "ring_id" if M == 1 else "paged_id"
    p = pool.eq_runtime.active.params
    with torch.inference_mode():
        state = pool._fresh_state()
        shape = (lanes, SPEAKERS, M, BLOCK) if M > 1 else (lanes, SPEAKERS, BLOCK)
        x = torch.empty(shape, device=dev).normal_(0.0, 0.25)
        idx = torch.arange(lanes, device=dev)
        dual = upols.xfade_conv_params(pool._conv_params, pool._conv_params)
        dual_ops = ChainOperands(pool._mac_bank(dual), pool._synth, None)
        mask = torch.ones(lanes, dtype=torch.bool, device=dev)

        def device_round(params, operands, ramp=None, lane_mask=None):
            nonlocal state
            state, _ = pool_step_body(
                params, p, p, state, x, idx, pool.eq_runtime.transition_length,
                True, False, variant, operands, ramp, lane_mask)

        steady_ms = cuda_ms(lambda: device_round(pool._conv_params,
                                                 pool._operands(p)), 5)
        fade_ms = cuda_ms(lambda: device_round(dual, dual_ops,
                                               pool._xfade_ramp, mask), 5)
        _, _, fade_ops = device_breakdown(
            lambda: device_round(dual, dual_ops, pool._xfade_ramp, mask))
    phase(label, card=smi, lanes=lanes, blocks_per_step=M,
          prewarm_seconds=prewarm_seconds, seconds=seconds,
          rounds=len(round_kinds), round_kinds=round_kinds,
          carry_bank_cycle=carry, launches=launches,
          fade_rounds=stats["fade_rounds"], debt_rolls=stats["debt_rolls"],
          lanes_sampled=sampled, paused_lane=paused,
          lane_fades=[rec.events[b] for b in sampled], lane_rel_rms=lane_err,
          steady_round_device_ms=steady_ms, fade_round_device_ms=fade_ms,
          fade_round_top_ops=fade_ops)
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"{label}: lane rel-RMS {lane_err} > {CHAIN_TOL}")
    if round_kinds[-1] != "steady" or pool._xfade_params is not None:
        raise AssertionError(f"{label}: the fades did not end")
    if not rec.events[paused] or stats["debt_rolls"] <= 0:
        raise AssertionError(f"{label}: the paused lane did not rejoin and fade")
    if any(c[0] != carry[0][0] or c[2] != carry[0][0] // M for c in carry):
        raise AssertionError(f"{label}: the carry's partitions or lane cycle "
                             f"moved with the renderer: {carry}")
    if len(wavs) > 2 and not carry[-1][1] < carry[-1][0]:
        raise AssertionError(f"{label}: the last bank was not shorter than the "
                             f"carry: {carry}")
    return launches


def checkpoint_phase(wav, dev: torch.device, rng: np.random.Generator,
                     smi: str) -> dict:
    """Both tiers at full width: snapshot() mid ragged traffic, the pool
    continued, the snapshot restored into a fresh pool fed the same rounds:
    the delivered audio must be equal. On the ring tier also half the lanes
    detached, a snapshot restored with resize=True into a 4096-lane pool,
    and the compacted lanes' audio must equal the uninterrupted lanes'."""
    launches = {}
    for M in (1, BLOCKS_PER_STEP):
        lanes = POOL_LANES[M]
        before, after = CHECKPOINT_ROUNDS[M]
        a = make_pool(wav, lanes, M, dev, bench_eq_definition())
        for _ in range(lanes):
            a.attach()
        settle(a)
        step = a.step_frames

        def ragged(among):
            fed = among[rng.random(len(among)) < POOL_SHARE]
            return fed, rng.standard_normal((len(fed), SPEAKERS, step),
                                            dtype=np.float32) * 0.25

        every = np.arange(lanes)
        for _ in range(before):
            feed_round(a, *ragged(every))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = a.snapshot()
        snapshot_seconds = time.perf_counter() - t0
        conv = snap["state"].conv
        nbytes = sum(leaf.nbytes for leaf in (
            (*conv.pages,) if M > 1 else (conv.fdl,)) + tuple(snap["state"].eq))
        b = make_pool(wav, lanes, M, dev, bench_eq_definition())
        t0 = time.perf_counter()
        b.restore(snap)
        torch.cuda.synchronize()
        restore_seconds = time.perf_counter() - t0
        del snap
        mk.reset_launch_count()
        equal, differ = True, 0.0
        for _ in range(after):
            fed, chunks = ragged(every)
            ya, yb = feed_round(a, fed, chunks), feed_round(b, fed, chunks)
            equal &= bool(np.array_equal(ya, yb))
            differ = max(differ, float(np.abs(ya - yb).max()))
        launches[f"checkpoint_{M}"] = launches_now()
        result = dict(lanes=lanes, blocks_per_step=M, rounds_continued=after,
                      snapshot_bytes=nbytes, snapshot_seconds=snapshot_seconds,
                      restore_seconds=restore_seconds, resumed_equal=equal,
                      resumed_max_abs_diff=differ)
        del b
        if M == 1:
            a_lanes = every[1::2]
            for s in every[::2]:
                a.detach(int(s))
            snap = a.snapshot()
            c = make_pool(wav, RESIZE_LANES, M, dev, bench_eq_definition())
            lane_map = c.restore(snap, resize=True)
            del snap
            mapped = np.array([lane_map[int(s)] for s in a_lanes])
            resized_equal, resized_differ = True, 0.0
            for _ in range(after):
                fed, chunks = ragged(a_lanes)
                ya = feed_round(a, fed, chunks)
                yc = feed_round(c, mapped[np.searchsorted(a_lanes, fed)],
                                chunks)
                resized_equal &= bool(np.array_equal(ya, yc))
                resized_differ = max(resized_differ, float(np.abs(ya - yc).max()))
            result.update(resized_lanes=RESIZE_LANES,
                          resized_compacted=bool(np.array_equal(
                              mapped, np.arange(len(a_lanes)))),
                          resized_equal=resized_equal,
                          resized_max_abs_diff=resized_differ)
            del c
        del a
        torch.cuda.empty_cache()
        phase("checkpoint", card=smi, **result)
        if not (result["resumed_equal"] and result.get("resized_equal", True)
                and result.get("resized_compacted", True)):
            raise AssertionError(f"checkpoint (M={M}): restored audio differs "
                                 f"from the uninterrupted pool's: {result}")
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    t_start = time.perf_counter()
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    rng = np.random.default_rng(args.seed)
    cases = kernel_phase(rng, dev)
    launches = bake_phase(rng, dev)
    timing_phase(args.seed, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        wav = hrir_wav(args.seed, tmp)
    for label, M in (("pool", 1), ("pool_paged", BLOCKS_PER_STEP)):
        pool, base, launches[label] = pool_phase(label, wav, dev, M, rng)
        pool_timing_phase(pool, base, smi)
        del pool, base
        torch.cuda.empty_cache()
    pool_retarget_phase(wav, dev, rng)
    with tempfile.TemporaryDirectory() as tmp:
        swap = [hrir_wav(args.seed + i, tmp) for i in (1, 2)]
        short = hrir_wav(args.seed + 3, tmp, SHORT_TAPS)
    hotswap = {
        "engine_hotswap": engine_hotswap_phase([wav, *swap], dev, rng, smi),
        "pool_ring_hotswap": pool_hotswap_phase(
            "hotswap_pool", [wav, swap[0]], dev, 1, rng, smi),
        "pool_paged_hotswap": pool_hotswap_phase(
            "hotswap_pool_paged", [wav, swap[0], short], dev, BLOCKS_PER_STEP,
            rng, smi),
    }
    checkpoints = checkpoint_phase(wav, dev, rng, smi)
    phase("done", seconds=time.perf_counter() - t_start)

    paths = {"bake_paged": launches[BLOCKS_PER_STEP],
             "bake_single_block": launches[1],
             "pool_ring": launches["pool"],
             "pool_paged": launches["pool_paged"],
             **{path: {name: counts[name]["total"] for name in KERNELS}
                for path, counts in {**hotswap, **checkpoints}.items()}}
    # Each kernel's headline case: the single block at B=16384 (bake M=1)
    # and the fused 3 pages (bake M=8 and the paged pool).
    entries = []
    for name, function in (("mac_kmajor", None),
                           ("mac_kmajor_pages", PAGED_MAC_FUNCTION)):
        own = [c for c in cases if c["kernel"] == name]
        main_case = own[0]
        by_path = {path: counts[name] for path, counts in paths.items()}
        entries.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "replaces_function": function,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in own),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "cases": own,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
