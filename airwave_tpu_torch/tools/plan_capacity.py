"""Pool capacity planner: how many serving lanes fit a card.

Port of scripts/plan_capacity.py with its flags and its one JSON line.
Given the workload shape (speakers, HRIR length, block, throughput tier,
profile groups) and a device-memory budget, it prints the per-lane cost
and the recommended max_streams. The numbers are the memory planner's
hand model (~2x fidelity: guidance, not an allocator) unless --calibrate
is passed: then a probe pool of --probe-batch lanes is built on the card
(or on --device), one round of each kind (steady, EQ crossfade, hot-swap)
runs on it, and the plan is sized from the allocator's measured peak
(utils/memory_planner.cuda_pool_round_memory; the contract is estimate
over measured peak <= 1.3).

--verify then builds a pool at the recommended max_streams on the device,
runs one round of each kind on its own carry and reports the measured peak
beside the estimate and the budget (utils/memory_planner.pool_round_peak).

Without --calibrate, --verify or --probe-hbm it touches no device.

    python -m airwave_tpu_torch.tools.plan_capacity --hrir-seconds 0.09
    python -m airwave_tpu_torch.tools.plan_capacity --hrir-seconds 1.0 \\
        --blocks-per-step 8 --groups 4 --hbm-gb 16
    python -m airwave_tpu_torch.tools.plan_capacity --blocks-per-step 8 \\
        --calibrate --verify --hbm-gb 24
"""

from __future__ import annotations

import argparse
import json
import sys

from airwave_tpu_torch.device import DEFAULT_DEVICE


def _build_pool(args, taps, lanes: int):
    """A pool of `lanes` lanes on --device for the workload: seeded random
    HRIRs of the given lengths, one per group, and a generic EQ so the
    eq_xfade round runs too (the preamp-only definition builds the same
    state shapes as any preset)."""
    import numpy as np

    from airwave_tpu_torch.assets import channel_maps as cm
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.io.apo import EqualizerDefinition
    from airwave_tpu_torch.io.wav import WAVData
    from airwave_tpu_torch.runtime.stream_pool import PoolProfile, StreamPool

    sr = args.sample_rate
    rng = np.random.default_rng(0)
    n_in = 14 if args.speakers == 2 else 2 * args.speakers
    layout = cm.STEREO if args.speakers == 2 else cm.SURROUND_7_1
    taps_list = taps if isinstance(taps, list) else [taps] * args.groups

    def renderer(t):
        audio = (rng.standard_normal((n_in, t)) * 0.05).astype(np.float32)
        return prepare_renderer(WAVData(sr, audio), layout, sr, args.block,
                                lookahead=args.blocks_per_step,
                                device=args.device)

    eq = EqualizerDefinition(preamp_db=-3.0)
    if args.groups > 1:
        return StreamPool(
            lanes, sr, block_size=args.block,
            blocks_per_step=args.blocks_per_step,
            profiles=[PoolProfile(renderer(t), eq) for t in taps_list],
            device=args.device)
    return StreamPool(lanes, sr, renderer(taps_list[0]), eq_definition=eq,
                      block_size=args.block,
                      blocks_per_step=args.blocks_per_step, device=args.device)


def _calibrate(args, taps) -> dict:
    """Build a probe pool of --probe-batch lanes on the device and measure
    its rounds (utils/memory_planner.cuda_pool_round_memory)."""
    from airwave_tpu_torch.utils.memory_planner import cuda_pool_round_memory

    g = max(1, args.groups)
    probe = max(g, (args.probe_batch + g - 1) // g * g)
    return cuda_pool_round_memory(_build_pool(args, taps, probe))


def _verify(args, taps, plan: dict) -> dict:
    """Build the recommended pool on the device, run one round of each kind
    on it (utils/memory_planner.pool_round_peak) and hold its measured peak
    against the plan's estimate and the budget it was sized into
    (budget_bytes: the headroom's share of the device's memory)."""
    from airwave_tpu_torch.utils.memory_planner import pool_round_peak

    n = plan["max_streams"]
    peak, pool = pool_round_peak(lambda: _build_pool(args, taps, n),
                                 args.device)
    del pool
    estimate = plan["params_bytes"] + plan["per_lane_bytes"] * n
    return {"max_streams": n, "peak_bytes": peak, "estimate_bytes": estimate,
            "estimate_over_peak": estimate / peak,
            "peak_over_budget_bytes": peak / plan["budget_bytes"],
            "fits": peak <= plan["budget_bytes"]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--speakers", type=int, default=2)
    ap.add_argument("--hrir-seconds", default="0.09",
                    help="HRIR length in seconds (0.09 = the bundled "
                         "4320-tap banks); a comma-separated list gives "
                         "per-group lengths for a heterogeneous grouped "
                         "pool (must match --groups)")
    ap.add_argument("--sample-rate", type=float, default=48_000.0)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--blocks-per-step", type=int, default=1,
                    help="throughput tier M (paged lookahead line)")
    ap.add_argument("--groups", type=int, default=1,
                    help="profile groups (grouped multi-tenant pool)")
    ap.add_argument("--hbm-gb", type=float, default=16.0,
                    help="per-device memory budget in GiB")
    ap.add_argument("--probe-hbm", action="store_true",
                    help="read the memory size from --device instead of "
                         "--hbm-gb")
    ap.add_argument("--mesh-devices", type=int, default=1,
                    help="devices in the pool's streams mesh")
    ap.add_argument("--headroom", type=float, default=0.85,
                    help="fraction of device memory to plan into")
    ap.add_argument("--calibrate", action="store_true",
                    help="build a --probe-batch pool on --device, run one "
                         "round of each kind and size from the allocator's "
                         "measured peak instead of the hand model")
    ap.add_argument("--verify", action="store_true",
                    help="build a pool at the recommended max_streams on "
                         "--device, run one round of each kind and report "
                         "its measured peak beside the estimate (exit 1 if "
                         "it is over the planned share of the budget)")
    ap.add_argument("--probe-batch", type=int, default=256,
                    help="probe pool size for --calibrate (per-lane cost "
                         "is linear in batch, so small probes calibrate "
                         "any target)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device of --calibrate and --probe-hbm "
                         "(default cuda:0)")
    ap.add_argument("--cpu", action="store_true",
                    help="--device cpu (--calibrate then fails: the "
                         "calibration measures the card's allocator)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.groups < 1 or args.blocks_per_step < 1 or args.mesh_devices < 1:
        ap.error("--groups/--blocks-per-step/--mesh-devices must be >= 1")
    if args.verify and args.mesh_devices != 1:
        ap.error("--verify builds the pool on one device (--mesh-devices 1)")

    from airwave_tpu_torch.utils.memory_planner import (device_hbm_bytes,
                                                        pool_capacity)

    hbm = (device_hbm_bytes(args.device) if args.probe_hbm
           else args.hbm_gb * 2**30)
    secs = [float(s) for s in str(args.hrir_seconds).split(",")]
    taps = [int(round(s * args.sample_rate)) for s in secs]
    if len(taps) == 1:
        taps = taps[0]
    elif len(taps) != args.groups:
        ap.error(f"--hrir-seconds lists {len(taps)} lengths but "
                 f"--groups is {args.groups}")
    calibration = None
    if args.calibrate:
        try:
            calibration = _calibrate(args, taps)
        except ValueError as err:
            ap.error(str(err))
    plan = pool_capacity(
        args.speakers, taps, args.block, lookahead=args.blocks_per_step,
        groups=args.groups, hbm_bytes=hbm, headroom=args.headroom,
        mesh_devices=args.mesh_devices, calibration=calibration,
    )
    out = {
        "speakers": args.speakers,
        "hrir_taps": taps,
        "block": args.block,
        "blocks_per_step": args.blocks_per_step,
        "groups": args.groups,
        "mesh_devices": args.mesh_devices,
        "hbm_bytes_per_device": int(hbm),
        **plan,
        "per_lane_kib": round(plan["per_lane_bytes"] / 1024, 1),
        "note": ("size max_streams to expected concurrency — every round "
                 "steps ALL lanes (docs/serving.md); "
                 + ("sized from the allocator's measured round peak "
                    "(<=1.3x fidelity)" if plan.get("calibrated") else
                    "estimates are ~2x fidelity (--calibrate tightens to "
                    "<=1.3x)")),
    }
    if calibration is not None:
        out["calibration"] = {
            "backend": calibration["backend"],
            "probe_batch": calibration["probe_batch"],
            "rounds": {k: v["per_lane_bytes"]
                       for k, v in calibration["rounds"].items()},
        }
    if args.verify and plan["max_streams"] > 0:
        try:
            out["verify"] = _verify(args, taps, plan)
        except ValueError as err:
            ap.error(str(err))
    print(json.dumps(out))
    fits = out.get("verify", {}).get("fits", True)
    return 0 if plan["max_streams"] > 0 and fits else 1


if __name__ == "__main__":
    sys.exit(main())
