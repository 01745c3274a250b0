"""Device-memory planning for the bake and the serving pool.

Port of airwave_tpu/utils/memory_planner.py. The estimators and
pool_capacity are the JAX package's arithmetic, unchanged, so both
planners give the same hand-model numbers for a shape:
  - `paged_partitions`, `estimate_paged_bake`: the paged (M-block
    lookahead) delay line and its working set;
  - `estimate_pool_lane_bytes`, `pool_capacity`: the per-lane cost of a
    StreamPool slot and the max_streams a memory budget holds (with
    `calibration=` from a measured round, and `mesh_devices`).
The hand model was fitted to another compiler's buffer assignment; on the
card the authority is the caching allocator. `cuda_pool_round_memory`
measures a probe pool's round (steady, EQ crossfade, hot-swap) with
torch.cuda's peak statistics, and its result replaces the hand model in
pool_capacity(calibration=...). `pool_round_peak` checks a plan: it
builds the pool and measures its rounds on its own carry (`run_round` is
the one round both measurements run).

`plan_paged_bake` orders (lookahead, batch split) attempts for a bake that
may not fit: the JAX ladder without its accumulation-chunk and unroll-cap
rungs, which the port has no use for (its paged MAC sums every page in one
launch and its bake is a Python loop). Estimates are coarse (within ~2x):
they order the ladder and skip hopeless attempts; the runtime OOM the
caller catches between attempts stays the judge.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device

F32 = 4


class PagedBakeEstimate(NamedTuple):
    fdl_bytes: int        # all delay-line pages
    live_term_bytes: int  # Ykm accumulation terms alive at once
    working_bytes: int    # frames + analysis output + projection slack
    total_bytes: int


class PlanAttempt(NamedTuple):
    lookahead: int
    # The JAX planner's accumulation chunk; always 0 here (the port's paged
    # MAC sums every page in one kernel launch, nothing to chunk).
    acc_chunk: int
    reason: str
    # The JAX planner's cap on a scan's unroll; always 0 here (the port's
    # bake is a Python loop, no scan).
    max_unroll: int = 0
    # Process the stream batch as this many sequential groups (1 = whole
    # batch). The terminal rung: a workload whose carry alone crowds out
    # the working set still completes, at the per-group batch's
    # throughput.
    batch_split: int = 1


def _padded_bins(block: int) -> int:
    k = block + 1
    return k + (-k) % 8


def paged_partitions(hrir_taps: int, block: int, lookahead: int) -> int:
    """Partition count of the paged line (exact mode): the half-window bank
    (real partitions + 1 — ops/upols._half_window_bank) plus M-1 zero tail
    slots, rounded up to whole pages (ops/upols make_conv_params lookahead
    handling)."""
    real = max(1, math.ceil(hrir_taps / block)) + 1
    need = real + lookahead - 1
    return need + (-need) % lookahead


def estimate_paged_bake(batch: int, speakers: int, hrir_taps: int,
                        block: int, lookahead: int,
                        acc_chunk: int = 0, ears: int = 2
                        ) -> PagedBakeEstimate:
    kp = _padded_bins(block)
    p2 = paged_partitions(hrir_taps, block, lookahead)
    n_pages = p2 // lookahead
    page = kp * speakers * 2 * lookahead * batch * F32
    fdl = n_pages * page
    term = kp * batch * lookahead * ears * 2 * F32
    # Unchunked, at most ~8 Ykm terms are counted live even at 13 pages
    # (the JAX package's measured bound, kept so both planners agree).
    live = (min(n_pages, 8) if acc_chunk <= 0
            else min(acc_chunk + 1, n_pages))
    live_terms = live * term
    # frames + new-page DFT output + folded projection output, ~2 pages.
    working = 2 * page + 2 * batch * speakers * lookahead * block * F32
    return PagedBakeEstimate(fdl, live_terms, working,
                             fdl + live_terms + working)


def plan_paged_bake(batch: int, speakers: int, hrir_taps: int, block: int,
                    lookahead: int, hbm_bytes: Optional[float] = None,
                    headroom: float = 0.92) -> List[PlanAttempt]:
    """Ordered (lookahead, batch_split) attempts for a paged bake: the JAX
    ladder (full speed, half-batch split, halved lookaheads, quarter-batch
    split) without its acc_chunk-only and max_unroll rungs.

    With `hbm_bytes` given, attempts whose estimate exceeds
    `headroom * hbm_bytes` are skipped when a cheaper attempt is predicted
    to fit — except the final fallback, which is always kept so the
    runtime OOM stays the authoritative judge.
    """
    candidates = [
        PlanAttempt(lookahead, 0, "full speed"),
        # Half-batch split BEFORE any reduced-lookahead rung: sequential
        # half-batch groups at full lookahead keep near-full per-stream
        # throughput, while reduced lookaheads lose the M-block batching.
        PlanAttempt(lookahead, 0,
                    "half-batch split (two sequential groups)", 0, 2),
    ]
    m = lookahead
    while m > 2:
        m //= 2
        candidates.append(PlanAttempt(m, 0, f"reduced lookahead M={m}"))
    # Terminal rung: quarter the resident batch at full lookahead.
    candidates.append(PlanAttempt(
        lookahead, 0, "quarter-batch split (four sequential groups)", 0, 4))

    if hbm_bytes is None:
        return candidates
    budget = headroom * float(hbm_bytes)
    fits = [
        c for c in candidates
        if estimate_paged_bake(batch // c.batch_split, speakers, hrir_taps,
                               block, c.lookahead,
                               c.acc_chunk).total_bytes <= budget
    ]
    # If NO attempt is predicted to fit, the coarse estimates have nothing
    # to choose between: keep the whole ladder and let the runtime OOM
    # judge.
    kept = fits if fits else list(candidates)
    # Always keep the final fallback: estimates are coarse by design.
    if kept[-1] != candidates[-1]:
        kept = kept + [candidates[-1]]
    return kept


def estimate_pool_lane_bytes(speakers: int, hrir_taps: int, block: int,
                             lookahead: int = 1, ears: int = 2,
                             eq_state_dim: int = 128) -> int:
    """Coarse per-lane HBM cost of a StreamPool slot: the carried state
    (delay line, EQ cascades) plus the lane's share of a round's
    working set (frames in, analysis slot, Ykm, stereo out; doubled for
    dispatch overlap slack). Same ~2x fidelity contract as
    estimate_paged_bake — sizing guidance, not an allocator."""
    kp = _padded_bins(block)
    if lookahead > 1:
        est = estimate_paged_bake(1, speakers, hrir_taps, block, lookahead,
                                  ears=ears)
        carry = est.fdl_bytes
        working = est.live_term_bytes + est.working_bytes
    else:
        p2 = max(1, math.ceil(hrir_taps / block)) + 1
        carry = kp * speakers * p2 * 2 * F32
        working = 2 * (
            speakers * block * F32          # harvested frames up
            + kp * speakers * 2 * F32       # analysis slot (+ read-back)
            + kp * ears * 2 * F32           # Ykm columns
            + ears * block * F32            # rendered rows down
        )
    eq = 2 * 2 * eq_state_dim * F32 + F32  # s_from + s_to [2, N] + counter
    return int(carry + working + eq)


def pool_capacity(speakers: int, hrir_taps, block: int,
                  lookahead: int = 1, groups: int = 1,
                  hbm_bytes: Optional[float] = None,
                  headroom: float = 0.85, ears: int = 2,
                  eq_state_dim: int = 128, mesh_devices: int = 1,
                  calibration: Optional[dict] = None) -> dict:
    """Recommend max_streams for a pool on a given HBM budget.

    `hrir_taps` may be one int (every group the same bank length) or a
    per-group sequence (heterogeneous grouped pools: each group carries
    its own delay line, so a short tenant pays only its own partitions).

    Returns a dict with the per-lane cost (mean across groups when
    heterogeneous), the (group-shared) parameter footprint, and
    `max_streams` = the largest lane count whose per-device share (lanes
    plus the REPLICATED params — every device holds the full filter
    banks/weights) fits `headroom * hbm_bytes`, rounded down to a
    multiple of groups * mesh_devices (grouped pools need equal segments;
    each group's state shards over the mesh). Serving throughput guidance
    lives in docs/serving.md ("provision max_streams near expected
    concurrency" — every round steps ALL lanes).

    `calibration`: a `cuda_pool_round_memory` result for this workload
    shape. When given, the hand per-lane/params model (~2x fidelity) is
    replaced by the allocator's measured numbers — per-lane cost and fixed
    bytes from a probe round on the card — tightening the recommendation
    (the contract: estimate over measured peak <= 1.3)."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes()
    kp = _padded_bins(block)
    k = block + 1
    taps_list = (list(hrir_taps) if hasattr(hrir_taps, "__len__")
                 else [int(hrir_taps)] * max(1, groups))
    if len(taps_list) != max(1, groups):
        raise ValueError(
            f"hrir_taps has {len(taps_list)} entries for groups={groups}"
        )
    if lookahead > 1:
        p2s = [paged_partitions(t, block, lookahead) for t in taps_list]
    else:
        # Half-window bank: real partitions + 1 (ops/upols
        # _half_window_bank), matching estimate_pool_lane_bytes.
        p2s = [max(1, math.ceil(t / block)) + 1 for t in taps_list]
    n = eq_state_dim
    params = (
        sum(speakers * ears * 2 * p2 * k * 2 * F32 for p2 in p2s)  # banks
        # wf is the HALF-window analysis [T, K, 2]; wi [K, 2, T].
        + block * k * 2 * F32 + k * 2 * block * F32        # DFT weights
        + 2 * groups * (block * block + 2 * block * n + n * n) * F32  # EQ
    )
    lanes = [estimate_pool_lane_bytes(speakers, t, block, lookahead,
                                      ears, eq_state_dim)
             for t in taps_list]
    lane = sum(lanes) / len(lanes)  # equal segments: mean per-lane cost
    calibrated = False
    if calibration is not None:
        # The allocator's measure of this workload shape: per-lane cost
        # from the probe round's peak (covers carry + the round's real
        # working set), fixed bytes from the params it holds. Per-lane heterogeneity collapses into the mean,
        # same as the hand model's equal-segment treatment.
        lane = float(calibration["per_lane_bytes"])
        params = float(calibration["fixed_bytes"])
        lanes = [lane] * len(taps_list)
        calibrated = True
    devices = max(1, int(mesh_devices))
    # Params are REPLICATED (every device holds the full banks/weights),
    # so they come out of each device's budget, not the pooled one.
    per_device_budget = headroom * float(hbm_bytes)
    lanes_per_device = max(0, int((per_device_budget - params) // lane))
    granularity = max(1, groups) * devices
    raw = lanes_per_device * devices
    max_streams = (raw // granularity) * granularity
    out = {
        "per_lane_bytes": int(lane),
        "per_group_lane_bytes": [int(b) for b in lanes],
        "params_bytes": int(params),
        "budget_bytes": int(per_device_budget * devices),
        "partitions": p2s if len(set(p2s)) > 1 else p2s[0],
        "max_streams": max_streams,
        "granularity": granularity,
        "calibrated": calibrated,
    }
    if calibrated and "steady" in calibration.get("rounds", {}):
        # max_streams covers the LARGEST round (a hot-swap round carries
        # the dual bank and its outputs); a pool that will never hot-swap
        # can size to the steady round.
        steady = calibration["rounds"]["steady"]["per_lane_bytes"]
        per_dev = max(0, int((per_device_budget
                              - calibration["rounds"]["steady"]
                              ["fixed_bytes"]) // steady))
        out["max_streams_steady"] = (per_dev * devices
                                     // granularity) * granularity
    return out


_ROUNDS = ("steady", "eq_xfade", "hotswap")
# Lanes of the throwaway carry each round kind first runs on, so what is
# allocated once per process exists before a measurement's baseline.
WARMUP_LANES = 8
# The caching allocator splits a cached or new block only when more than
# this would remain, so a live block may hold up to this much beyond its
# request, however many lanes it serves.
_UNSPLIT_BYTES = 1 << 20


def _tensor_bytes(tree) -> int:
    """Bytes of the distinct storages behind the tensors of a tree of
    tuples (a fade bank shares its DFT weights with the active bank)."""
    seen, stack = {}, [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, tuple):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            storage = node.untyped_storage()
            seen[storage.data_ptr()] = storage.nbytes()
    return sum(seen.values())


def _probe_state(pool, lanes: int):
    """A zeroed pool carry of `lanes` lanes per group with the pool's
    partition counts, on the pool's device."""
    from airwave_tpu_torch.ops import eq_block, upols
    from airwave_tpu_torch.runtime.stream_pool import EARS, PoolState

    S, T, M = pool.renderer.num_speakers, pool.block_size, pool.blocks_per_step
    convs, eqs = [], []
    for parts in pool._bank_partitions:
        convs.append(
            upols.make_conv_state_paged(lanes, S, parts, T, M, pool.device)
            if M > 1 else upols.make_conv_state(lanes, S, parts, T,
                                                pool.device))
        eqs.append(eq_block.make_eq_state(lanes, EARS,
                                          pool.config.eq_state_dim,
                                          pool.device))
    return PoolState(pool._pack(convs), pool._pack(eqs))


def _held_params(pool) -> tuple:
    """Everything of the pool's own on the device but its carry: the
    renderers' banks, the active banks and their operands, and every EQ
    cascade its EQ runtimes hold (unity, active, pending, retiring)."""
    from airwave_tpu_torch.graph.eq_runtime import PreparedEq

    cascades = tuple(v.params for rt in pool.eq_runtimes
                     for v in vars(rt).values() if isinstance(v, PreparedEq))
    return (tuple(r.conv_params for r in pool.renderers),
            tuple((b.params, b.mac, b.synth) for b in pool._banks), cascades)


def _round_operands(pool, name: str):
    """(conv params, operands, eq params, crossfading, xfade) of one round
    kind; every derived operand is built (and cached by the pool) here."""
    eq = pool._pack(rt.active.params for rt in pool.eq_runtimes)
    if name == "hotswap":
        fades = [pool._self_fade(g) for g in range(pool.groups)]
        return (pool._pack(f[0] for f in fades),
                pool._pack(f[1] for f in fades), eq, False, True)
    operands = pool._pack(pool._operands(rt.active.params, g)
                          for g, rt in enumerate(pool.eq_runtimes))
    return pool._conv_params, operands, eq, name == "eq_xfade", False


def run_round(pool, name: str, lanes: "int | None" = None, state=None,
              blocks: "torch.Tensor | None" = None):
    """One device round of kind `name` (steady, eq_xfade or hotswap) with
    every lane harvested through the masked variant (scatter, mask,
    gather), the largest working set: on `state` when given (a carry of
    the pool's shape, such as its own), else on a fresh zeroed carry of
    `lanes` lanes per group (default the pool's group size); on `blocks`
    when given, else on zero input, on the pool's device. Returns the
    round's (state, y)."""
    from airwave_tpu_torch.runtime.stream_pool import pool_step_body

    params, operands, eq, crossfading, xfade = _round_operands(pool, name)
    lanes = pool.group_size if lanes is None else lanes
    B = lanes * pool.groups
    S, T, M = pool.renderer.num_speakers, pool.block_size, pool.blocks_per_step
    if state is None:
        state = _probe_state(pool, lanes)
    if blocks is None:
        blocks = torch.zeros((B, S, M, T) if M > 1 else (B, S, T),
                             device=pool.device)
    idx = torch.arange(B, device=pool.device)
    ramp = mask = None
    if xfade:
        ramp = torch.zeros(pool.step_frames, device=pool.device)
        mask = torch.zeros(B, dtype=torch.bool, device=pool.device)
    return pool_step_body(params, eq, eq, state, blocks, idx,
                          pool.eq_runtime.transition_length, pool._eq_enabled,
                          crossfading, "paged" if M > 1 else "ring", operands,
                          ramp, mask)


def round_kinds(pool, rounds=_ROUNDS) -> list:
    """The kinds of `rounds` the pool can run (eq_xfade needs its EQ)."""
    unknown = set(rounds) - set(_ROUNDS)
    if unknown:
        raise ValueError(f"unknown round kinds {sorted(unknown)}: expected "
                         f"some of {_ROUNDS}")
    return [k for k in rounds if k != "eq_xfade" or pool._eq_enabled]


@torch.inference_mode()
def cuda_pool_round_memory(pool, rounds=_ROUNDS) -> dict:
    """The measured device-memory footprint of a StreamPool's round on the
    card, per round kind, from the caching allocator's statistics.

    `rounds` selects the kinds that bound the peak (capacity must cover the
    LARGEST round a serving pool can hit): "steady", "eq_xfade" (an EQ
    retarget's crossfade, the dual EQ pass; skipped on a pool without EQ)
    and "hotswap" (a crossfaded HRIR swap: the dual bank and its outputs).

    Each kind first runs once on a small throwaway carry, so what is
    allocated once per process (the cuBLAS workspace, the kernel's module)
    and the pool's derived operands (the fade bank, the folded synthesis)
    exist before the baseline and are not charged to the lanes. Then, per
    kind: the peak statistics are reset, a fresh carry at the pool's lane
    count is made and one round runs on device-resident input; the
    allocation above the baseline is the carry, the input and the round's
    working set. The round's params are the pool's banks with their MAC
    and synthesis operands (the fade bank in a hot-swap round), the DFT
    weights and every EQ cascade the pool holds: peak = params +
    (max_memory_allocated - baseline) and per_lane = ceil((peak - params)
    / lanes). `fixed` is the params plus the allocator's rounding
    allowance: a block is split only when more than 1 MiB would remain, so
    each block live at the peak may hold up to 1 MiB it was not asked for,
    whatever the lane count; the probe's own rounding, spread over its few
    lanes, is not a bound for a pool of many more.

    Returns the JAX planner's keys: per_lane_bytes and fixed_bytes (the
    largest over the rounds), carry_bytes_exact (the pool's carry),
    probe_batch, rounds {kind: {peak_bytes, fixed_bytes, per_lane_bytes,
    params_bytes, rounding_bytes}} and backend "cuda". A CPU pool raises
    ValueError: this measures the card's allocator and has no CPU
    counterpart."""
    if pool.device.type != "cuda":
        raise ValueError(
            f"cuda_pool_round_memory needs a CUDA pool (this one is on "
            f"{pool.device}): it reads the card's allocator statistics")
    kinds = round_kinds(pool, rounds)
    dev = pool.device
    for name in kinds:  # the once-per-process allocations and the operands
        run_round(pool, name, WARMUP_LANES)
        torch.cuda.synchronize(dev)
    B = pool.max_streams
    lanes = pool.group_size
    out_rounds = {}
    for name in kinds:
        params = _tensor_bytes((_round_operands(pool, name)[:3],
                                _held_params(pool)))
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        baseline = torch.cuda.memory_allocated(dev)
        blocks = torch.cuda.memory_stats(dev)["allocation.all.current"]
        torch.cuda.reset_peak_memory_stats(dev)
        result = run_round(pool, name, lanes)
        torch.cuda.synchronize(dev)
        delta = torch.cuda.max_memory_allocated(dev) - baseline
        live = torch.cuda.memory_stats(dev)["allocation.all.peak"] - blocks
        del result
        rounding = live * _UNSPLIT_BYTES
        out_rounds[name] = {
            "peak_bytes": int(params + delta),
            "fixed_bytes": int(params + rounding),
            "per_lane_bytes": int(math.ceil(delta / B)),
            "params_bytes": int(params),
            "rounding_bytes": int(rounding),
        }
    torch.cuda.empty_cache()
    return {
        "per_lane_bytes": max(r["per_lane_bytes"] for r in out_rounds.values()),
        "fixed_bytes": max(r["fixed_bytes"] for r in out_rounds.values()),
        "carry_bytes_exact": _tensor_bytes(pool._state),
        "probe_batch": B,
        "rounds": out_rounds,
        "backend": "cuda",
    }


@torch.inference_mode()
def pool_round_peak(build, device: "torch.device | str" = DEFAULT_DEVICE,
                    rounds=_ROUNDS) -> tuple:
    """A plan checked on the card: the device bytes above the allocation
    before `build()` at the peak of building the pool it returns (on
    `device`) and running one round of each kind in `rounds` on the pool's
    own carry and device-resident zero input, the largest working set each
    kind can reach (run_round). Returns (peak_bytes, pool); the pool's
    carry is the one those rounds left. A device other than CUDA raises
    ValueError: this reads the card's allocator."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"pool_round_peak needs a CUDA device, got {dev}: "
                         f"it reads the card's allocator statistics")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    pool = build()
    if pool.device != dev:
        raise ValueError(f"the pool is on {pool.device}, not on {dev}")
    for name in round_kinds(pool, rounds):
        pool._state, y = run_round(pool, name, state=pool._state)
        del y
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev) - base), pool


def device_hbm_bytes(device: "torch.device | str" = DEFAULT_DEVICE) -> float:
    """The card's device memory in bytes
    (torch.cuda.get_device_properties(...).total_memory). Raises without a
    card; a CPU device is a ValueError (it has no device memory to plan)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_hbm_bytes needs a CUDA device, got {dev}")
    return float(torch.cuda.get_device_properties(dev).total_memory)
