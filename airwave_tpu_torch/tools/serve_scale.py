"""Wire-layer scale harness: N concurrent clients against a live
RenderServer, loopback.

Port of scripts/measure_serve_scale.py with its flags and JSON line. The
server runs in THIS process on a pool of --pool-streams lanes (default
clients + 8) with a tiny seeded 300-tap bank (the step is deliberately
small: this measures the wire layer, not the DSP); the port's load
generator (shell/loadgen, one selector thread, realtime-paced clients) runs
as a SEPARATE process, so client-side work never shares the server's GIL.

Prints progress to stderr and ONE JSON result line to stdout: the load
generator's metrics (admission and chunk latency percentiles, completions,
fairness), the server's counters and wire latency, and "device". Runs the
pool on --device (the card by default; it raises without one); the CPU only
with --device cpu or --cpu.

--io-mode is passed to the server as given. The script passes it only when
it is not "thread" (its default), so its server runs the servers' default
plane, the selector, under either value; the port's default is that plane.

    python -m airwave_tpu_torch.tools.serve_scale --clients 1024
        [--io-mode selector|thread] [--blocks-each 30] [--speed 1.0]
        [--pool-streams N] [--device cuda:0 | --cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from airwave_tpu_torch.device import DEFAULT_DEVICE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SAMPLE_RATE = 48_000.0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--clients", type=int, default=256)
    parser.add_argument("--blocks-each", type=int, default=30)
    parser.add_argument("--chunk", type=int, default=512)
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--pool-streams", type=int, default=0,
                        help="pool max_streams (default clients+8)")
    parser.add_argument("--io-mode", default="selector",
                        choices=["thread", "selector"],
                        help="the server's data plane (default selector: "
                             "the plane the script's default runs)")
    parser.add_argument("--connect-burst", type=int, default=64)
    parser.add_argument("--timeout", type=float, default=300.0)
    parser.add_argument("--batch-window", type=float, default=0.002)
    parser.add_argument("--skip-prewarm", action="store_true")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device of the pool (default cuda:0)")
    parser.add_argument("--cpu", action="store_true", help="--device cpu")
    return parser


def build_server(args, device):
    """The script's pool (seed 7's 300-tap bank, stereo, block --chunk) on
    `device`, prewarmed unless --skip-prewarm, behind a started server."""
    from airwave_tpu_torch.assets import channel_maps as cm
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.io.wav import WAVData
    from airwave_tpu_torch.runtime.stream_pool import StreamPool
    from airwave_tpu_torch.shell.serve import RenderServer

    block = args.chunk
    pool_streams = args.pool_streams or args.clients + 8
    rng = np.random.default_rng(7)
    audio14 = (rng.standard_normal((14, 300)) * 0.2).astype(np.float32)
    renderer = prepare_renderer(WAVData(SAMPLE_RATE, audio14), cm.STEREO,
                                SAMPLE_RATE, block, device=device)
    pool = StreamPool(pool_streams, SAMPLE_RATE, renderer, block_size=block,
                      device=device)
    t0 = time.monotonic()
    if not args.skip_prewarm:
        print(f"prewarming pool ({pool_streams} lanes)...", file=sys.stderr)
        pool.prewarm()
        print(f"prewarm done in {time.monotonic() - t0:.1f}s",
              file=sys.stderr)
    server = RenderServer(pool, port=0, client_timeout=args.timeout,
                          batch_window=args.batch_window, io_mode=args.io_mode)
    server.start()
    return server


def measure(args, device) -> dict:
    """Drive --clients loadgen clients (a child process) against the
    server; returns the script's result fields and "device"."""
    server = build_server(args, device)
    try:
        host, port = server.address
        cmd = [
            sys.executable, "-m", "airwave_tpu_torch.shell.loadgen",
            "--connect", f"{host}:{port}",
            "--clients", str(args.clients),
            "--blocks-each", str(args.blocks_each),
            "--chunk", str(args.chunk),
            "--speed", str(args.speed),
            "--connect-burst", str(args.connect_burst),
            "--timeout", str(args.timeout),
        ]
        print(f"driving {args.clients} clients (io_mode={args.io_mode})...",
              file=sys.stderr)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        t1 = time.monotonic()
        proc = subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=args.timeout + 60)
        wall = time.monotonic() - t1
        if proc.returncode not in (0, 1) or not proc.stdout.strip():
            print(proc.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"loadgen failed rc={proc.returncode}")
        load = json.loads(proc.stdout.strip().splitlines()[-1])
        stats = server.stats()
    finally:
        server.stop()
    pool = server.pool
    return {
        "io_mode": args.io_mode,
        "pool_streams": pool.max_streams,
        "load": load,
        "server": {
            "connections_served": stats["connections_served"],
            "protocol_errors": stats["protocol_errors"],
            "pump_errors": stats["pump_errors"],
            "rejected_full": stats["rejected_full"],
            "truncated_closes": stats["truncated_closes"],
            "latency": stats["latency"],
        },
        "harness_wall_s": round(wall, 3),
        "device": str(pool.device),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    from airwave_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    result = measure(args, device)
    if device.type == "cuda":
        import torch

        result["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    sys.exit(main())
