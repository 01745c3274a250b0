"""Serving-checkpoint cost at production scale: every phase of a pool
snapshot's save and restore, timed.

Port of scripts/measure_checkpoint_scale.py with its flags, phases and JSON
line. A B=16,384 M=8 pool's snapshot is gigabytes. What matters
operationally is not the total wall time (the save runs on the serve shell's
control thread) but the PUMP STALL: `RenderServer.save_checkpoint` holds the
pump lock only for `pool.snapshot(materialize=False)`, a device-side copy of
the carry, while the readback to the host, the serialization and the
fsync'd atomic write happen outside the lock on the copied buffers.

Phases, in order, on a pool of --batch lanes with a seeded 14-channel bank
of --hrir-seconds and no EQ (the script's pool):
  1. --rounds warm rounds on 8 lanes (real data in the carry);
  2. the pump stall: snapshot(materialize=False) and a synchronize;
  3. the readback of the copy to the host (the pool's own fetch);
  4. utils.checkpoint.save_pool_snapshot (the raw container, atomic);
  5. load_pool_snapshot into a fresh pool of the same construction;
  6. restore and a synchronize.
Then every carry leaf of the two pools is compared bit for bit
(roundtrip_exact). Prints one JSON line, deletes the file, exit 1 unless the
round trip is exact. Runs on --device (the card by default; it raises
without one); the CPU only with --device cpu or --cpu.

    python -m airwave_tpu_torch.tools.checkpoint_scale --batch 16384 \\
        --blocks-per-step 8 [--out PATH] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from airwave_tpu_torch.device import DEFAULT_DEVICE

SAMPLE_RATE = 48_000.0
HRIR_CHANNELS = 14
WARM_LANES = 8


def _leaves(tree) -> list:
    """The carry's leaves in order: tensors, and the ring cursor."""
    if isinstance(tree, tuple):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def _same(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
    return int(a) == int(b)


def measure(batch: int = 16_384, block: int = 512, blocks_per_step: int = 8,
            hrir_seconds: float = 0.09, rounds: int = 1, out: str = None,
            device=DEFAULT_DEVICE) -> dict:
    """Run the phases (module docstring) and return the result line's
    fields. The checkpoint file is written at
    utils.checkpoint.checkpoint_path(out) (default under the temporary
    directory) and deleted before returning."""
    import numpy as np
    import torch

    from airwave_tpu_torch.assets import channel_maps as cm
    from airwave_tpu_torch.device import resolve_device
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.io.wav import WAVData
    from airwave_tpu_torch.runtime.stream_pool import (StreamPool, _map_carry,
                                                       _to_host)
    from airwave_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    load_pool_snapshot,
                                                    save_pool_snapshot)

    dev = resolve_device(device)
    if out is None:
        out = os.path.join(tempfile.gettempdir(), "pool_ckpt_scale")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    taps = int(round(hrir_seconds * SAMPLE_RATE))
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((HRIR_CHANNELS, taps)) * 0.05).astype(
        np.float32)
    M = blocks_per_step
    renderer = prepare_renderer(WAVData(SAMPLE_RATE, audio), cm.STEREO,
                                SAMPLE_RATE, block, lookahead=M, device=dev)

    def new_pool():
        return StreamPool(batch, SAMPLE_RATE, renderer, block_size=block,
                          blocks_per_step=M, device=dev)

    pool = new_pool()
    # Real data in a few lanes: the snapshot's cost is bound by the carry's
    # shape, not its values.
    lanes = [pool.attach() for _ in range(min(WARM_LANES, batch))]
    chunk = (rng.standard_normal((2, M * block)) * 0.3).astype(np.float32)
    for _ in range(rounds):
        for lane in lanes:
            pool.push(lane, chunk)
        pool.pump()
        for lane in lanes:
            pool.pull(lane, pool.available(lane))

    sync()
    # Phase 1, the pump stall: the device-side copy of the carry under the
    # serving lock.
    t0 = time.perf_counter()
    snap = pool.snapshot(materialize=False)
    sync()
    t1 = time.perf_counter()
    # Phase 2: the copy's readback to the host, outside the lock.
    snap["state"] = _map_carry(_to_host, snap["state"])
    t2 = time.perf_counter()
    # Phase 3: the fsync'd atomic write, outside the lock.
    save_pool_snapshot(out, snap)
    t3 = time.perf_counter()
    path = checkpoint_path(out)
    try:
        size = os.path.getsize(path)
        del snap
        # Phase 4: load and restore into a fresh pool of the same shape.
        pool2 = new_pool()
        t4 = time.perf_counter()
        loaded = load_pool_snapshot(out, pool2)
        t5 = time.perf_counter()
        pool2.restore(loaded)
        sync()
        t6 = time.perf_counter()
    finally:
        os.remove(path)
    a, b = _leaves(pool._state), _leaves(pool2._state)
    exact = len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    carry = sum(t.numel() * t.element_size() for t in a
                if isinstance(t, torch.Tensor))
    return {
        "metric": "pool checkpoint cost at scale",
        "batch": batch,
        "blocks_per_step": M,
        "carry_gib": carry / 2**30,
        "file_gib": size / 2**30,
        "pump_stall_ms": (t1 - t0) * 1e3,
        "materialize_ms": (t2 - t1) * 1e3,
        "write_ms": (t3 - t2) * 1e3,
        "save_total_ms": (t3 - t0) * 1e3,
        "load_ms": (t5 - t4) * 1e3,
        "restore_ms": (t6 - t5) * 1e3,
        "roundtrip_exact": bool(exact),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16_384)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--blocks-per-step", type=int, default=8)
    ap.add_argument("--hrir-seconds", type=float, default=0.09)
    ap.add_argument("--rounds", type=int, default=1,
                    help="warm pump rounds before the measurement (puts "
                         "real data in the carry)")
    ap.add_argument("--out", default=None,
                    help="checkpoint path (default pool_ckpt_scale in the "
                         "temporary directory); deleted after the run")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda:0)")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result = measure(args.batch, args.block, args.blocks_per_step,
                     args.hrir_seconds, args.rounds, args.out,
                     "cpu" if args.cpu else args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["roundtrip_exact"] else 1


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    sys.exit(main())
