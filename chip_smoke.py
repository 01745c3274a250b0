"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one line before the last:
  1. device: require CUDA, print the card's name and power limit
     (nvidia-smi), apply and check the strict fp32 precision policy;
  2. build: build the mac_kmajor kernel (nvcc) and the native frame
     assembler (g++) from their sources, both at once;
  3. kernel: mac_kmajor against its plain PyTorch version on the card at the
     paths' shapes (single-block K=520 R=40 O=4 at B=16384 and at the ring
     pool's B=8192, and 3 accumulated pages R=32 O=32 at B=16384), with
     errors, CUDA-event times of the kernel, the plain version and the one
     PyTorch call of the same function, and the bound from bytes and FLOPs;
  4. bake: models.bake.bake at full width (B=16384 streams, S=2, T=512, a
     synthetic 4320-tap HRIR bank, a 10-filter EQ) over 32 blocks with
     blocks_per_step=8 and 1; the outputs are finite and non-silent, the two
     modes agree, 4 sampled lanes match a float64 reference (scipy
     fftconvolve then sosfilt), and the kernel's launch count rose in both;
  5. timing: the paged chain on device-resident input for 192 blocks, as
     bench.py:measure times the JAX chain (for the record only);
  6. pool: the serving pool's ring tier (StreamPool, 8192 lanes, 48 kHz)
     from a synthetic 14-channel HRIR WAV written and loaded back by the
     port's io.wav, through prepare_renderer, with the 10-filter EQ; 48
     rounds of ragged traffic (each lane fed with probability 0.75, so the
     masked step runs and lanes rejoin with debt), then full rounds
     (ring_all with one lane detached, ring_id after it re-attaches); 4
     sampled lanes within 1e-5 of float64, the kernel launched, debt rolls
     run;
  7. pool_paged: the same at blocks_per_step=8 on 16384 lanes;
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
from airwave_tpu_torch.models.binaural import BinauralChain, ChainState
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import eq_block, upols
from airwave_tpu_torch.runtime.stream_pool import StreamPool, pool_step_body

SAMPLE_RATE = 48_000.0
BATCH, SPEAKERS, EARS, BLOCK, HRIR_TAPS = 16384, 2, 2, 512, 4320
BLOCKS_PER_STEP = 8
BAKE_BLOCKS = 32
TIMED_BLOCKS = 192
KERNEL_TOL = 1e-6   # rel-RMS, kernel vs plain version (fp32 reassociation)
CHAIN_TOL = 1e-5    # rel-RMS, the BASELINE.md chain contract
KERNEL_SOURCE = "airwave_tpu_torch/kernels/csrc/mac_kmajor.cu"
KERNEL_REPLACES = "airwave_tpu/kernels/mac_kmajor.py:66"
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
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    phase("build", seconds=seconds, ptxas=ptxas)


def kernel_phase(rng: np.random.Generator, dev: torch.device) -> list:
    """The kernel against its plain version at the paths' shapes, both also
    against a float64 evaluation of the same contraction, and the one
    PyTorch call that computes the same function (library_ms)."""
    Kp = upols.padded_bin_count(BLOCK)
    cases = []

    def tensor(shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=dev)

    def single_block_case(B):
        # R = S * P2 * 2 with P2 = 10 (9 partitions + 1), O = E * 2.
        fdl, h = tensor((Kp, 40, B)), tensor((Kp, 4, 40))
        return (f"single_block K={Kp} R=40 O=4 B={B}",
                lambda: mk.mac_kmajor(fdl, h), lambda: mk.mac_kmajor_ref(fdl, h),
                lambda: mk.mac_kmajor_ref(fdl.double(), h.double()),
                lambda: torch.einsum("krb,kor->okb", fdl, h),
                bound(4 * (fdl.numel() + h.numel() + 4 * Kp * B),
                      2 * Kp * 40 * 4 * B))

    def paged_case():
        pages = [tensor((Kp, 32, BATCH)) for _ in range(3)]
        hp = [tensor((Kp, 32, 32)) for _ in range(3)]
        stacked, h_stacked = torch.stack(pages), torch.stack(hp)

        def kern():
            acc = mk.mac_kmajor(pages[0], hp[0])
            for p, q in zip(pages[1:], hp[1:]):
                mk.mac_kmajor(p, q, out=acc, accumulate=True)
            return acc

        def plain():
            acc = mk.mac_kmajor_ref(pages[0], hp[0])
            for p, q in zip(pages[1:], hp[1:]):
                acc = acc + mk.mac_kmajor_ref(p, q)
            return acc

        return (f"paged 3 pages K={Kp} R=32 O=32 B={BATCH}", kern, plain,
                lambda: sum(mk.mac_kmajor_ref(p.double(), q.double())
                            for p, q in zip(pages, hp)),
                lambda: torch.einsum("pkrb,pkor->okb", stacked, h_stacked),
                bound(4 * (stacked.numel() + h_stacked.numel()
                           + 32 * Kp * BATCH),
                      2 * 3 * Kp * 32 * 32 * BATCH))

    for make in (lambda: single_block_case(BATCH),
                 lambda: single_block_case(POOL_LANES[1]), paged_case):
        name, kern, plain, exact_fn, library, bnd = make()
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
        case = dict(case=name, max_abs_err=max_abs, rel_rms=rel,
                    rel_rms_vs_fp64=rel_exact,
                    plain_rel_rms_vs_fp64=plain_rel_exact,
                    library_rel_rms_vs_fp64=library_rel,
                    ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 20),
                    library_ms=cuda_ms(library, 20), **bnd)
        phase("kernel", **case)
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: rel-RMS {rel} > {KERNEL_TOL}")
        cases.append(case)
        torch.cuda.empty_cache()
    return cases


def reference_lane(hrir, x, preamp, coeffs):
    """float64 reference of the chain for one lane's input x [S, n]: per
    speaker and ear fftconvolve, summed over speakers, then the EQ cascade
    (sosfilt of the port's design_cascade coefficients, preamp first)."""
    from scipy.signal import fftconvolve, sosfilt

    n = x.shape[-1]
    sos = np.array([[c.b0, c.b1, c.b2, 1.0, c.a1, c.a2] for c in coeffs])
    out = np.zeros((EARS, n))
    for e in range(EARS):
        dry = sum(fftconvolve(x[s].astype(np.float64),
                              hrir[s, e].astype(np.float64))[:n]
                  for s in range(SPEAKERS))
        out[e] = sosfilt(sos, preamp * dry)
    return out


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


def hrir_wav(seed: int, directory: str) -> wavio.WAVData:
    """A seeded synthetic 14-channel 4320-frame HRIR bank, written as a WAV
    file by the port's io.wav and loaded back: the renderer's asset path."""
    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((HRIR_CHANNELS, HRIR_TAPS)) * 0.05).astype(
        np.float32)
    bank[:, 0] += 0.8
    path = os.path.join(directory, "hrir14.wav")
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
    launches = mk.launch_count()
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
    if launches <= 0:
        raise AssertionError(f"{label}: mac_kmajor was not launched")
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
    phase("done", seconds=time.perf_counter() - t_start)

    by_path = {"bake_paged": launches[BLOCKS_PER_STEP],
               "bake_single_block": launches[1],
               "pool_ring": launches["pool"],
               "pool_paged": launches["pool_paged"]}
    main_case = cases[-1]
    print(json.dumps({"kernels": [{
        "name": "mac_kmajor", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "cases": cases,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
