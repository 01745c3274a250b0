"""Per-kernel device-time profile of the render chain (bench configurations).

Port of scripts/profile_chain.py with its flags, defaults, argument errors,
printed rows and JSON keys. It runs the sync-proof runner (bench.py:measure's
pattern: `--blocks` blocks a call, a checksum fetched to the host inside the
trace) under torch.profiler with CUDA activity and prints the device time of
each kernel, aggregated by name (the port's counterpart of the XLA fusions:
cuBLAS GEMMs, the MAC kernels, the elementwise and copy kernels), sorted,
the top `--top`, then one JSON line:

  trace_dir                the directory holding the Chrome trace
                           (trace.json), --logdir or a new temporary one;
  sum_listed_ms_per_block  the listed rows' total over the blocks traced;
  device_ms_per_block      CUDA-event time over the same calls (each call
                           bracketed by its own pair of events), so that
                           device_ms_per_block - sum_listed_ms_per_block is
                           what the listed rows leave unattributed (idle
                           gaps inside a call, and the rows past --top);
                           "not measured" on the CPU;
  device                   the card's name, or "cpu".

On the CPU (--cpu or --device cpu) the rows are the CPU ops by self time
(host time, not a device metric).

The bake (default) is headline_chain: bench.py:build's chain (a seeded
bank of --speakers x 2 ears, 4320 taps or --hrir-seconds long,
bench.py:_finish_build's 10-filter EQ, lookahead --blocks-per-step,
default 8) on device-resident input. bench.py prefers the reference
assets' Neutral bank and synthesizes this bank where they are absent; the
port always synthesizes it (--synthetic-hrir is accepted for the script's
sake). --pool profiles the serving pool's saturated "_id" round instead
(tools/soak.build_pool and make_call: --batch lanes, --pool-groups profile
groups, the tier --blocks-per-step or --pool-blocks, default 1).

    python -m airwave_tpu_torch.tools.profile_chain [--batch 8192]
        [--blocks-per-step 8] [--hrir-seconds 1.0] [--blocks 16]
        [--pool [--pool-blocks M] [--pool-groups G]] [--calls 2]
        [--top 40] [--logdir DIR] [--device cuda:0 | --cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from airwave_tpu_torch.device import DEFAULT_DEVICE
from airwave_tpu_torch.utils.profiling import SPAN_PREFIX

BLOCK = 512
SAMPLE_RATE = 48_000.0
EARS = 2
HRIR_TAPS = 4320      # bench.py:build's hrir_len
INPUT_SCALE = 0.25    # bench.py's device input: 0.25 * N(0, 1)
EQ_TRANSITION = 960   # the 20 ms EQ crossfade at 48 kHz
# A trace on the card loses the first kernel records of its window (one to
# four on an H100): that many spin kernels open the window and take the
# loss, and their rows are left out.
LEAD_KERNELS = 8
LEAD_KERNEL_NAME = "spin_kernel"   # torch.cuda._sleep's kernel


def bake_hrir(seed: int, speakers: int, hrir_seconds=None) -> np.ndarray:
    """bench.py:build's synthesized bank [speakers, 2, L]: with
    hrir_seconds a 0.02 N(0, 1) tail decaying over 0.3 s, else 4320 taps of
    0.05 N(0, 1); a 0.8 direct tap either way."""
    rng = np.random.default_rng(seed)
    if hrir_seconds:
        taps = int(hrir_seconds * SAMPLE_RATE)
        hrir = (rng.standard_normal((speakers, EARS, taps)) * 0.02).astype(
            np.float32)
        hrir *= np.exp(-np.arange(taps) / (0.3 * SAMPLE_RATE))
    else:
        hrir = (rng.standard_normal((speakers, EARS, HRIR_TAPS))
                * 0.05).astype(np.float32)
    hrir[:, :, 0] += 0.8
    return hrir


def headline_chain(seed: int, device, batch: int = 16384,
                   blocks_per_step: int = 8, hrir_seconds=None,
                   speakers: int = 2):
    """The bake chain bench.py times (its headline: B=16384, M=8, the
    4320-tap bank, the 10-filter EQ): (chain, zero state, one step's input
    on `device`, 0.25 N(0, 1) drawn there from `seed`: [B, S, M, T], or
    [B, S, T] at M=1)."""
    import torch

    from airwave_tpu_torch.device import resolve_device
    from airwave_tpu_torch.models.binaural import BinauralChain, ChainState
    from airwave_tpu_torch.ops import biquad_design, eq_block, upols
    from airwave_tpu_torch.tools.soak import bench_eq_definition

    dev = resolve_device(device)
    M = int(blocks_per_step)
    hrir = bake_hrir(seed, speakers, hrir_seconds)
    preamp, coeffs = biquad_design.design_cascade(bench_eq_definition(),
                                                  SAMPLE_RATE)
    conv_params = upols.make_conv_params(hrir, BLOCK, pad_to_pow2=False,
                                         lookahead=M, device=dev)
    eq = eq_block.make_eq_params(coeffs, preamp, BLOCK, device=dev)
    chain = BinauralChain(conv_params, eq, eq, EQ_TRANSITION, BLOCK,
                          blocks_per_step=M)
    P = conv_params.partition_count
    conv = (upols.make_conv_state_paged(batch, speakers, P, BLOCK, M, dev)
            if M > 1 else upols.make_conv_state(batch, speakers, P, BLOCK,
                                                dev))
    state = ChainState(conv=conv, eq=eq_block.make_eq_state(batch,
                                                            device=dev))
    shape = ((batch, speakers, M, BLOCK) if M > 1
             else (batch, speakers, BLOCK))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) * INPUT_SCALE
    return chain, state, x


def bake_call(chain, state, x, blocks: int):
    """A function running one sync-proof call of the bake: blocks / M chain
    steps on the carry (advanced in place of the caller's), returning the
    [8, 128] checksum of every step's output as a tensor on the device (not
    fetched), as bench.py:make_runner's."""
    import torch

    M = chain.blocks_per_step
    if blocks < M or blocks % M:
        raise ValueError(f"--blocks {blocks} must be a multiple of "
                         f"--blocks-per-step {M}")
    carry = [state]

    @torch.inference_mode()
    def call():
        acc = torch.zeros((8, 128), device=x.device)
        for _ in range(blocks // M):
            carry[0], y = chain(carry[0], x)
            acc += y.reshape(-1, 8, 128).sum(0)
        return acc

    return call


def build_call(batch: int, blocks: int, blocks_per_step: int,
               hrir_seconds=None, speakers: int = 2, pool: bool = False,
               pool_groups: int = 1, device=DEFAULT_DEVICE, seed: int = 0):
    """(call, blocks per call): the bake's call (bake_call on
    headline_chain), or with pool=True the pool's saturated round
    (tools/soak.make_call on build_pool and device_input; blocks rounded up
    to a multiple of the tier, as the script plans its pool schedule)."""
    if pool:
        from airwave_tpu_torch.tools import soak

        M = blocks_per_step
        built = soak.build_pool(batch, hrir_seconds, speakers, M, pool_groups,
                                device)
        blocks = blocks + (-blocks) % M
        return soak.make_call(built, soak.device_input(built, seed),
                              blocks), blocks
    chain, state, x = headline_chain(seed, device, batch, blocks_per_step,
                                     hrir_seconds, speakers)
    return bake_call(chain, state, x, blocks), blocks


def lead_kernels(device) -> None:
    """Open a trace's window on the card: LEAD_KERNELS tiny spin kernels,
    then a synchronize, so that the records the trace loses at its start
    are theirs (rows named LEAD_KERNEL_NAME, which the caller leaves
    out)."""
    import torch

    with torch.cuda.device(device):
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def profile(call, device, calls: int, blocks: int, top: int = 40,
            logdir=None) -> dict:
    """Trace `calls` calls of `call` (each fetching its checksum inside the
    trace, or, where it returns None, synchronizing the card; one call
    before them warms the profiler up, and on a card lead_kernels opens
    the traced window) with torch.profiler and aggregate by
    name: on a card (`device` cuda) the CUDA kernels by device time, on the
    CPU the CPU ops by self time. Returns rows [(name, total_us, count)]
    (the top `top`; every row with top=None), the Chrome trace's directory,
    the listed rows' ms per block and, on a card, the CUDA-event ms per
    block of the same calls. Warm `call` up first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    # One more call than traced: the profiler's warm-up, whose events are
    # dropped (a session can miss the kernels of its first moments).
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=calls,
                                       repeat=1)
    events = []
    with torch_profile(activities=activities, schedule=schedule) as prof:
        for i in range(calls + 1):
            if on_card and i == 1:
                lead_kernels(device)
            if on_card and i:
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                pair[0].record()
            acc = call()
            if on_card and i:
                pair[1].record()
                events.append(pair)
            # Fetch inside the trace: force real execution.
            if acc is not None:
                acc.to("cpu")
            elif on_card:
                torch.cuda.synchronize(device)
            prof.step()
    logdir = logdir or tempfile.mkdtemp(prefix="airwave_trace_")
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    kind = DeviceType.CUDA if on_card else DeviceType.CPU
    totals = [(e.key, (e.self_device_time_total if on_card
                       else e.self_cpu_time_total), e.count)
              for e in prof.key_averages() if e.device_type == kind
              and not e.key.startswith("ProfilerStep")  # the schedule's
              and not e.key.startswith(SPAN_PREFIX)     # the program's spans
              and LEAD_KERNEL_NAME not in e.key]
    rows = sorted((r for r in totals if r[1] > 0), key=lambda r: -r[1])[:top]
    blocks_total = blocks * calls
    device_ms = ("not measured" if not on_card else
                 sum(a.elapsed_time(b) for a, b in events) / blocks_total)
    return {
        "rows": rows,
        "trace_dir": logdir,
        "sum_listed_ms_per_block": sum(us for _, us, _ in rows) / 1e3
        / blocks_total,
        "device_ms_per_block": device_ms,
        "blocks_total": blocks_total,
        "on_card": on_card,
    }


def print_profile(result: dict, calls: int, blocks: int, batch: int, M: int,
                  hrir_seconds, device: str) -> None:
    """The script's comment line and rows, then the JSON line."""
    what = "device time per kernel" if result["on_card"] else (
        "host time per CPU op")
    print(f"# {what} over {calls} calls x {blocks} blocks (B={batch}, "
          f"M={M}, hrir_seconds={hrir_seconds})")
    for name, us, count in result["rows"]:
        per_block_ms = us / 1e3 / result["blocks_total"]
        print(f"{per_block_ms:9.4f} ms/block  {us/1e3:9.2f} ms total "
              f"x{count:<5d} {name[:110]}")
    device_ms = result["device_ms_per_block"]
    print(json.dumps({
        "trace_dir": result["trace_dir"],
        "sum_listed_ms_per_block": round(result["sum_listed_ms_per_block"],
                                         4),
        "device_ms_per_block": (round(device_ms, 4)
                                if isinstance(device_ms, float)
                                else device_ms),
        "device": device,
    }), flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--blocks", type=int, default=16,
                    help="blocks per traced call")
    ap.add_argument("--blocks-per-step", type=int, default=None,
                    help="lookahead M (bake chain default 8; with --pool "
                         "it selects the serving tier, default 1)")
    ap.add_argument("--hrir-seconds", type=float, default=None)
    ap.add_argument("--speakers", type=int, default=2)
    ap.add_argument("--synthetic-hrir", action="store_true",
                    help="synthesized bank (the port's bank always is)")
    ap.add_argument("--calls", type=int, default=2, help="traced calls")
    ap.add_argument("--pool", action="store_true",
                    help="profile the serving pool's round instead of the "
                         "bake chain")
    ap.add_argument("--pool-groups", type=int, default=1,
                    help="with --pool: profile the grouped multi-profile "
                         "round")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="alias for --blocks-per-step in --pool mode "
                         "(StreamPool(blocks_per_step=M), paged_id round)")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda:0; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--cpu", action="store_true",
                    help="--device cpu (tiny shapes recommended)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The script's arguments, checked as it checks them."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.pool_blocks is not None:
        if not args.pool:
            ap.error("--pool-blocks requires --pool")
        if (args.blocks_per_step is not None
                and args.blocks_per_step != args.pool_blocks):
            ap.error(f"--pool-blocks {args.pool_blocks} conflicts with "
                     f"--blocks-per-step {args.blocks_per_step}")
        args.blocks_per_step = args.pool_blocks
    if args.pool_groups < 1:
        ap.error("--pool-groups must be >= 1")
    if args.pool_groups > 1:
        if not args.pool:
            ap.error("--pool-groups requires --pool")
        if args.batch % args.pool_groups:
            ap.error(f"--batch {args.batch} must divide by --pool-groups "
                     f"{args.pool_groups}")
    if args.blocks_per_step is None:
        args.blocks_per_step = 1 if args.pool else 8
    if args.cpu:
        args.device = "cpu"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from airwave_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    call, blocks = build_call(args.batch, args.blocks, args.blocks_per_step,
                              args.hrir_seconds, args.speakers, args.pool,
                              args.pool_groups, device)
    call().to("cpu")  # warm-up (outside the trace)
    result = profile(call, device, args.calls, blocks, args.top, args.logdir)
    print_profile(result, args.calls, blocks, args.batch,
                  args.blocks_per_step, args.hrir_seconds,
                  torch.cuda.get_device_name(device)
                  if device.type == "cuda" else str(device))
    return 0


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    sys.exit(main())
