"""Sustained on-card serving soak: the StreamPool's device round driven
continuously for minutes of wall-clock on one card.

Port of scripts/soak_device.py with its flags, checks and JSON line. The
serving soak of tests/test_soak.py exercises the whole serving stack on the
CPU; this tool is its device-side complement: it holds the POOL ROUND
(runtime/stream_pool.pool_step_body, the computation `StreamPool.pump`
dispatches, in its saturated "_id" variant: every lane harvested) at steady
state on the pool's own carry for `--seconds` and checks what only a long
run can show:

  * numerical health over millions of blocks: every fetched checksum
    finite, and no drift of the output statistic (a recurrent carry that
    slowly blows up looks fine in a 3-call bench);
  * timing stability: per-call ms per block percentiles and the tail ratio
    (throttling or background contention shows here);
  * sustained throughput: the realtime multiple over the WHOLE window
    (host dispatch gaps included), not a best-of-N;
  * on a card, the live device tensors (the bytes they asked the caching
    allocator for, and their count) after the baseline call and at the end
    of the window: the carry is rewritten in place, so they must not grow.

The pool is built here (build_pool): a seeded 14-channel HRIR bank (0.09 s,
the bundled 4320-tap shape, unless --hrir-seconds) through prepare_renderer
and the 10-filter EQ of bench.py:_finish_build (per group its variation
from bench.py:build_pool), its construction-time EQ ramp run to its end
(settle_eq) so the rounds apply the target cascade.

Sync-proof as bench.py:measure: each call sums its outputs on the device
and the sum is fetched to the host before the call's timer stops. Prints one
JSON line (scripts/soak_device.py's keys, and the kernels' launch counts);
exit 1 on any health failure. Runs on --device (the card by default; it
raises without one); the CPU only with --device cpu or --cpu (small shapes).

    python -m airwave_tpu_torch.tools.soak [--seconds 300] [--batch 8192]
        [--pool-blocks M] [--pool-groups G] [--hrir-seconds S[,S2,..]]
        [--blocks-per-call 256] [--speakers 2] [--device cuda:0 | --cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from airwave_tpu_torch.device import DEFAULT_DEVICE

BLOCK = 512
SAMPLE_RATE = 48_000.0
HRIR_CHANNELS = 14   # a HeSuVi 14-channel bank, as the assets ship
HRIR_TAPS = 4320     # the bundled banks' length (0.09 s)
INPUT_SCALE = 0.25   # bench.py's device input: 0.25 * N(0, 1)


def bench_eq_definition(group: int = 0):
    """bench.py:build_pool's 10-filter EQ of profile group `group`; group 0
    is bench.py:_finish_build's."""
    from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                          FilterType)

    kinds = (FilterType.PEAKING, FilterType.LOW_SHELF, FilterType.HIGH_SHELF)
    filters = tuple(
        EqualizerFilter(i + 1, i + 1, True, kinds[i % 3],
                        100.0 * (i + 1) + 60.0 + 13.0 * group,
                        (-1.0) ** i * (2.0 + 0.3 * group), 0.9)
        for i in range(10)
    )
    return EqualizerDefinition(-2.5 + 0.5 * group, filters)


def hrir_bank(seed: int, taps: int, sample_rate: float = SAMPLE_RATE):
    """A seeded 14-channel HRIR bank of `taps` frames (0.05 * N(0, 1) with a
    0.8 direct tap), as a WAVData."""
    from airwave_tpu_torch.io.wav import WAVData

    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((HRIR_CHANNELS, taps)) * 0.05).astype(
        np.float32)
    bank[:, 0] += 0.8
    return WAVData(sample_rate, bank)


def build_pool(batch: int, hrir_seconds=None, speakers: int = 2,
               blocks_per_step: int = 1, groups: int = 1,
               device=DEFAULT_DEVICE):
    """The soak's pool on `device`: `groups` profile groups (group g's bank
    seeded with g, `hrir_seconds` one length or one per group, default the
    4320-tap shape; bench_eq_definition(g)), speakers laid out by
    channel_maps.detect_layout, block 512 at 48 kHz, and its EQ ramp run to
    its end (settle_eq)."""
    from airwave_tpu_torch.assets import channel_maps
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.runtime.stream_pool import PoolProfile, StreamPool

    if groups < 1 or batch % groups:
        raise ValueError(f"batch ({batch}) must divide by the profile-group "
                         f"count ({groups})")
    if isinstance(hrir_seconds, (list, tuple)):
        if len(hrir_seconds) != groups:
            raise ValueError(f"{len(hrir_seconds)} HRIR lengths for "
                             f"{groups} profile groups")
        seconds = list(hrir_seconds)
    else:
        seconds = [hrir_seconds] * groups
    layout = channel_maps.detect_layout(speakers)
    profiles = []
    for g, s in enumerate(seconds):
        taps = HRIR_TAPS if s is None else int(s * SAMPLE_RATE)
        renderer = prepare_renderer(hrir_bank(g, taps), layout, SAMPLE_RATE,
                                    BLOCK, lookahead=blocks_per_step,
                                    device=device)
        profiles.append(PoolProfile(renderer, bench_eq_definition(g)))
    if groups == 1:
        pool = StreamPool(batch, SAMPLE_RATE, profiles[0].renderer,
                          eq_definition=profiles[0].eq_definition,
                          block_size=BLOCK, blocks_per_step=blocks_per_step,
                          device=device)
    else:
        pool = StreamPool(batch, SAMPLE_RATE, block_size=BLOCK,
                          blocks_per_step=blocks_per_step, profiles=profiles,
                          device=device)
    settle_eq(pool)
    return pool


def settle_eq(pool) -> None:
    """Run each group's construction-time unity -> target EQ ramp to its
    end: one lane per group is fed silence through the ramp's rounds, pulled
    and detached. Afterwards each group's active cascade is its target and
    no transition is pending."""
    lanes = [pool.attach(g) for g in range(pool.groups)]
    S = pool.renderer.num_speakers
    silence = np.zeros((len(lanes), S, pool.step_frames), np.float32)
    rounds = -(-pool.eq_runtime.transition_length // pool.step_frames) + 1
    for _ in range(rounds):
        pool.push_many(lanes, silence)
        pool.pump(max_rounds=1)
        pool.pull_many(lanes, pool.step_frames)
    for lane in lanes:
        pool.detach(lane)
    busy = [g for g, rt in enumerate(pool.eq_runtimes)
            if rt.is_transitioning or rt.pending_target is not None]
    if busy:
        raise RuntimeError(f"EQ ramp of groups {busy} did not settle in "
                           f"{rounds} rounds")


def device_input(pool, seed: int = 0):
    """One round's input for every lane, 0.25 * N(0, 1) drawn on the pool's
    device from `seed`: [B, S, T], or [B, S, M, T] on the paged tier."""
    import torch

    S, M = pool.renderer.num_speakers, pool.blocks_per_step
    shape = ((pool.max_streams, S, M, pool.block_size) if M > 1
             else (pool.max_streams, S, pool.block_size))
    gen = torch.Generator(device=pool.device).manual_seed(seed)
    # Drawn and scaled in place: no second input-sized tensor at the peak.
    return torch.empty(shape, device=pool.device).normal_(
        generator=gen).mul_(INPUT_SCALE)


def make_call(pool, x, blocks_per_call: int):
    """A function running one soak call: blocks_per_call / M saturated
    rounds ("ring_id" or "paged_id", every lane harvested) of `pool` on its
    own carry and the device-resident input `x`, each group's bank and EQ
    target; it returns the call's checksum, the sum over lanes of every
    round's output, as a tensor on the device (not fetched). The ring step
    writes the delay line in place; the carry the rounds leave is the
    pool's."""
    import torch

    from airwave_tpu_torch.runtime.stream_pool import pool_step_body

    M = pool.blocks_per_step
    if pool.shard_count != 1:
        raise ValueError("the soak runs an unsharded pool (mesh=None)")
    if blocks_per_call < M or blocks_per_call % M:
        raise ValueError(f"blocks_per_call ({blocks_per_call}) must be a "
                         f"multiple of blocks_per_step ({M})")
    steps = blocks_per_call // M
    variant = "paged_id" if M > 1 else "ring_id"
    targets = [rt.active.params for rt in pool.eq_runtimes]
    eq = pool._pack(targets)
    operands = pool._pack(pool._operands(q, g) for g, q in enumerate(targets))
    params = pool._conv_params
    idx = torch.arange(pool.max_streams, device=pool.device)

    @torch.inference_mode()
    def call():
        acc = None
        for _ in range(steps):
            state, y = pool_step_body(params, eq, eq, pool._state, x, idx,
                                      pool.eq_runtime.transition_length,
                                      pool._eq_enabled, False, variant,
                                      operands)
            # The pool lets go of the page the step retired, as pump does:
            # holding the call's first carry would keep pages alive.
            pool._state = state
            acc = y.sum(0) if acc is None else acc.add_(y.sum(0))
        return acc

    call.variant = variant
    return call


def _device_memory(dev) -> dict:
    """The caching allocator's counters after a synchronize: the bytes the
    live tensors asked for and their count (the soak's growth check), and
    the allocated bytes (each block rounded up, and a reused cached block
    may hold up to 1 MiB more than asked, so these move by reuse alone) and
    their peak since the caller's last reset."""
    import torch

    torch.cuda.synchronize(dev)
    stats = torch.cuda.memory_stats(dev)
    return {"device_requested_bytes": stats["requested_bytes.all.current"],
            "device_live_allocations": stats["allocation.all.current"],
            "device_allocated_bytes": torch.cuda.memory_allocated(dev),
            "device_max_allocated_bytes": torch.cuda.max_memory_allocated(
                dev)}


def soak(pool, x, seconds: float, blocks_per_call: int) -> dict:
    """Soak `pool` for `seconds` of wall-clock after a warm-up call and a
    settled baseline call (make_call's calls on its own carry and `x`).
    Returns scripts/soak_device.py's result fields; on a card also the
    caching allocator's counters (_device_memory) after the baseline call
    and at the end of the window (device_*_baseline, device_*_end). "pass"
    is false on a non-finite checksum, on an output statistic whose last
    quarter's mean over the baseline's lies outside (0.5, 2.0), or on live
    device tensors that grew over the window (their requested bytes or
    their count)."""
    import torch

    call = make_call(pool, x, blocks_per_call)
    dev = pool.device
    on_card = dev.type == "cuda"

    def fetch(acc) -> np.ndarray:
        return acc.to("cpu").numpy()  # the sync point of a call

    # Warm-up: the first call's checksum holds the zero-state transient.
    fetch(call())
    baseline = float(np.abs(fetch(call())).mean())
    if on_card:
        baseline_memory = _device_memory(dev)

    call_ms, sums, failures = [], [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        host = fetch(call())  # the timer stops after the fetch
        dt = time.perf_counter() - t0
        call_ms.append(1e3 * dt / blocks_per_call)
        if not np.all(np.isfinite(host)):
            failures.append("non-finite checksum")
            break
        sums.append(float(np.abs(host).mean()))
    window = time.perf_counter() - t_start

    calls = len(call_ms)
    if calls == 0:
        return {"metric": "on-device serving soak", "pass": False,
                "error": "no calls completed"}
    ms = np.asarray(call_ms)
    # With stationary random input and fixed filters the per-call output
    # statistic is stationary too: a recurrence that accumulates error
    # trends away from the settled baseline.
    tail_mean = float(np.mean(sums[-max(1, calls // 4):])) if sums else 0.0
    drift_ratio = tail_mean / baseline if baseline else float("inf")
    if not (0.5 < drift_ratio < 2.0):
        failures.append(f"output drift: tail/baseline = {drift_ratio:.3g}")

    blocks_total = calls * blocks_per_call
    audio_seconds = (pool.max_streams * blocks_total * pool.block_size
                     / pool.sample_rate)
    p50, p99 = (float(np.percentile(ms, q)) for q in (50, 99))
    result = {
        "metric": "on-device serving soak",
        "pass": False,
        "seconds": window,
        "calls": calls,
        "blocks": blocks_total,
        "blocks_per_call": blocks_per_call,
        "batch_streams": pool.max_streams,
        "variant": call.variant,
        "sustained_x_realtime": audio_seconds / window,
        "ms_per_block_mean": float(ms.mean()),
        "ms_per_block_p50": p50,
        "ms_per_block_p99": p99,
        "ms_per_block_max": float(ms.max()),
        "tail_ratio_p99_over_p50": p99 / p50,
        "output_drift_ratio": drift_ratio,
        "device": (torch.cuda.get_device_name(dev) if on_card
                   else str(dev)),
    }
    if on_card:
        end_memory = _device_memory(dev)
        for key, value in baseline_memory.items():
            result[f"{key}_baseline"] = value
            result[f"{key}_end"] = end_memory[key]
        for key in ("device_requested_bytes", "device_live_allocations"):
            if end_memory[key] > baseline_memory[key]:
                failures.append(f"device memory grew: {key} "
                                f"{baseline_memory[key]} -> {end_memory[key]}")
    if pool.groups > 1:
        result["profile_groups"] = pool.groups
    if pool.blocks_per_step > 1:
        result["blocks_per_step"] = pool.blocks_per_step
    result["pass"] = not failures
    if failures:
        result["failures"] = failures
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=300.0,
                        help="soak window (wall-clock) after warmup")
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--blocks-per-call", type=int, default=256,
                        help="blocks per call (one timing sample)")
    parser.add_argument("--pool-blocks", type=int, default=1,
                        help="multi-block throughput tier (StreamPool "
                             "blocks_per_step=M)")
    parser.add_argument("--pool-groups", type=int, default=1,
                        help="grouped multi-profile pool (G tenants)")
    parser.add_argument("--hrir-seconds", default=None,
                        help="HRIR length in seconds; with --pool-groups "
                             "G a comma list gives per-group lengths")
    parser.add_argument("--speakers", type=int, default=2)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device (default cuda:0; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--cpu", action="store_true",
                        help="--device cpu (tiny shapes recommended)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    hrir_seconds = None
    if args.hrir_seconds is not None:
        parts = [float(s) for s in str(args.hrir_seconds).split(",")]
        if len(parts) == 1:
            hrir_seconds = parts[0]
        else:
            if args.pool_groups != len(parts):
                parser.error(f"--hrir-seconds lists {len(parts)} lengths "
                             f"but --pool-groups is {args.pool_groups}")
            hrir_seconds = parts
    if args.pool_groups < 1 or args.batch % args.pool_groups:
        parser.error("--batch must divide by --pool-groups (>= 1)")
    if args.blocks_per_call % args.pool_blocks:
        parser.error("--blocks-per-call must be a multiple of --pool-blocks")

    from airwave_tpu_torch.device import resolve_device
    from airwave_tpu_torch.kernels import mac_kmajor as mk

    device = resolve_device(args.device)
    pool = build_pool(args.batch, hrir_seconds, args.speakers,
                      args.pool_blocks, args.pool_groups, device)
    result = soak(pool, device_input(pool), args.seconds,
                  args.blocks_per_call)
    if hrir_seconds is not None:
        result["hrir_seconds"] = hrir_seconds
    # Counted since the process started: the pool's settle rounds and
    # every soak call (a CPU tensor runs the plain version: no launch).
    result["launches"] = {name: mk.launch_count(name)
                          for name in ("mac_kmajor", "mac_kmajor_pages")}
    print(json.dumps(result), flush=True)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    sys.exit(main())
