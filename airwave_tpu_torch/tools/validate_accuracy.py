"""On-card accuracy gate: the full chain against the float64 oracles.

Port of scripts/validate_accuracy.py with its modes and its one JSON line.
It runs the flagship conv+EQ chain (the bundled HRIR's shapes, 4320 taps,
and a 10-filter cascade) on --device (the card by default; the CPU only
when asked) for --speakers input channels (2 stereo, 6 for 5.1, 8 for 7.1:
channel_maps.detect_layout), each speaker's ear pair taken from a seeded
14-channel bank through the HeSuVi 14 map, and reports the worst lane's
rel-RMS error against the port's float64 oracles (oracle/upols_oracle,
oracle/eq_oracle): the BASELINE.md <=1e-5 contract, or the relaxed tier's
1e-4 with --contract.
The line carries device.precision_stamp(). Exit 1 when the worst lane
misses --contract. Imports no jax: it runs on the card's machine.

    python -m airwave_tpu_torch.tools.validate_accuracy [--blocks-per-step 8]
        [--speakers 8]
    python -m airwave_tpu_torch.tools.validate_accuracy --pool [--pool-groups 2]
    AIRWAVE_MATMUL_PRECISION=high python -m \\
        airwave_tpu_torch.tools.validate_accuracy --blocks-per-step 8 \\
        --contract 1e-4
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from airwave_tpu_torch.device import DEFAULT_DEVICE

T, SAMPLE_RATE = 512, 48_000.0
HRIR_CHANNELS = 14
SPEAKERS = (2, 6, 8)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device (default cuda:0; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--blocks", type=int, default=24)
    parser.add_argument("--blocks-per-step", type=int, default=1,
                        help="validate the M-block lookahead (paged) chain")
    parser.add_argument("--speakers", type=int, default=2, choices=SPEAKERS,
                        help="input channels, the layout by "
                             "channel_maps.detect_layout: 2 stereo, 6 5.1, "
                             "8 7.1 (every channel of the 14-channel bank)")
    parser.add_argument("--pool", action="store_true",
                        help="validate the serving pool's ring step "
                             "(shared cursor + masked writes + debt rolls "
                             "under a ragged pause schedule)")
    parser.add_argument("--pool-groups", type=int, default=1,
                        help="with --pool: validate the grouped "
                             "multi-profile pool (G distinct HRIR banks + "
                             "EQ cascades, each lane vs its own group's "
                             "f64 oracle)")
    parser.add_argument("--contract", type=float, default=1e-5,
                        help="rel-RMS pass threshold. 1e-5 is the strict "
                             "tier (highest, the default); 1e-4 gates the "
                             "relaxed tier (run with "
                             "AIRWAVE_MATMUL_PRECISION=high)")
    parser.add_argument("--hrir-seconds", default=None,
                        help="HRIR length in seconds (default 0.09 = the "
                             "bundled 4320-sample shape); with --pool "
                             "--pool-groups G a comma list gives per-group "
                             "lengths (heterogeneous grouped pool)")
    return parser


def _hrir_seconds(parser, args):
    if args.hrir_seconds is None:
        return None
    parts = [float(s) for s in str(args.hrir_seconds).split(",")]
    if len(parts) == 1:
        return [parts[0]] * args.pool_groups
    if not (args.pool and args.pool_groups > 1):
        parser.error("--hrir-seconds takes a comma list only with "
                     "--pool --pool-groups G")
    if len(parts) != args.pool_groups:
        parser.error(f"--hrir-seconds lists {len(parts)} lengths "
                     f"but --pool-groups is {args.pool_groups}")
    return parts


def _profiles(G: int, hrir_seconds, layout):
    """The script's seeded banks and EQ definitions, one per group: each
    bank a [14, taps] HeSuVi file's channels, resolved for `layout` by the
    renderer's build_hrir_time_domain into [S, 2, taps]."""
    from airwave_tpu_torch.graph.renderer import build_hrir_time_domain
    from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                          FilterType)
    from airwave_tpu_torch.io.wav import WAVData
    from airwave_tpu_torch.ops import biquad_design as bd

    hrirs, eq_defs, designs = [], [], []
    for g in range(G):
        n_g = 4320 if hrir_seconds is None else int(hrir_seconds[g] * 48_000)
        bank = (np.random.default_rng(g).standard_normal((HRIR_CHANNELS, n_g))
                * 0.05).astype(np.float32)
        bank[:, 0] += 0.8
        hrirs.append(build_hrir_time_domain(WAVData(SAMPLE_RATE, bank),
                                            layout, SAMPLE_RATE))
        filt = tuple(
            EqualizerFilter(i + 1, i + 1, True,
                            (FilterType.PEAKING, FilterType.LOW_SHELF,
                             FilterType.HIGH_SHELF)[i % 3],
                            100.0 * (i + 1) + 60.0 + 11.0 * g,
                            (-1.0) ** i * (2.0 + 0.25 * g), 0.9)
            for i in range(10)
        )
        eq_defs.append(EqualizerDefinition(-2.5 + 0.4 * g, filt))
        designs.append(bd.design_cascade(eq_defs[-1], SAMPLE_RATE))
    return hrirs, eq_defs, designs


def _run_pool(args, dev, hrirs, eq_defs, x, N):
    """The serving path under a ragged pause schedule: lanes pause at
    different rounds, so the masked write and the debt rolls run (with
    --blocks-per-step M, the paged tier's page rolls)."""
    from airwave_tpu_torch.assets.channel_maps import detect_layout
    from airwave_tpu_torch.graph.renderer import RendererState
    from airwave_tpu_torch.ops import upols
    from airwave_tpu_torch.runtime.stream_pool import PoolProfile, StreamPool

    B, G, M = args.batch, args.pool_groups, args.blocks_per_step
    S = args.speakers
    step_t = M * T

    def renderer(h):
        return RendererState(
            conv_params=upols.make_conv_params(h, T, pad_to_pow2=False,
                                               lookahead=M, device=dev),
            speakers=detect_layout(S).channels, sample_rate=SAMPLE_RATE,
            block_size=T, lookahead=M)

    if G > 1:
        pool = StreamPool(B, SAMPLE_RATE, block_size=T,
                          ring_blocks=max(N + 2, 4), blocks_per_step=M,
                          profiles=[PoolProfile(renderer(hrirs[g]), eq_defs[g])
                                    for g in range(G)], device=dev)
        streams = [pool.attach(g) for g in range(G) for _ in range(B // G)]
    else:
        pool = StreamPool(B, SAMPLE_RATE, renderer(hrirs[0]),
                          eq_definition=eq_defs[0], block_size=T,
                          ring_blocks=max(N + 2, 4), blocks_per_step=M,
                          device=dev)
        streams = [pool.attach() for _ in range(B)]
    # Let the activation unity->target ramp finish on silence so the
    # steady state matches the oracle's immediate-target application.
    ramp_rounds = -(-960 // step_t) + 1
    for _ in range(ramp_rounds):
        for s in streams:
            pool.push(s, np.zeros((S, step_t), np.float32))
        pool.pump()
    for s in streams:
        pool.pull(s, ramp_rounds * step_t)
    fed = [0] * B
    n_chunks = N // M
    for rnd in range(4 * n_chunks):
        if all(f >= n_chunks for f in fed):
            break
        for j, s in enumerate(streams):
            # Ragged: lane j pauses on rounds where (rnd % (j+2)) == 0.
            if fed[j] < n_chunks and (j == 0 or rnd % (j + 2) != 0):
                pool.push(s, x[j, :, fed[j] * step_t:(fed[j] + 1) * step_t])
                fed[j] += 1
        pool.pump()
    return np.stack([pool.pull(s, N * T) for s in streams])


def _run_chain(args, dev, hrir, design, x, N):
    """chain_step_fn over N blocks, or chain_step_multi_fn over N/M steps."""
    import torch

    from airwave_tpu_torch.models.binaural import (ChainState, chain_step_fn,
                                                   chain_step_multi_fn,
                                                   make_chain_operands)
    from airwave_tpu_torch.ops import eq_block, upols

    B, M, S = args.batch, args.blocks_per_step, args.speakers
    preamp, coeffs = design
    eq_params = eq_block.make_eq_params(coeffs, preamp, T, device=dev)
    conv_params = upols.make_conv_params(hrir, T, pad_to_pow2=False,
                                         lookahead=M, device=dev)
    P = conv_params.partition_count
    conv = (upols.make_conv_state_paged(B, S, P, T, M, dev) if M > 1
            else upols.make_conv_state(B, S, P, T, dev))
    state = ChainState(conv=conv, eq=eq_block.make_eq_state(B, device=dev))
    operands = make_chain_operands(conv_params, eq_params, M,
                                   upols.padded_bin_count(T))
    xd = torch.tensor(x, device=dev)
    outs = []
    with torch.inference_mode():
        for i in range(N // M):
            xm = xd[:, :, i * M * T:(i + 1) * M * T]
            if M > 1:
                state, y = chain_step_multi_fn(
                    conv_params, eq_params, eq_params, state,
                    xm.reshape(B, S, M, T), 960, eq_enabled=True,
                    eq_crossfading=False, operands=operands)
                outs.extend(y[:, m] for m in range(M))
            else:
                state, y = chain_step_fn(
                    conv_params, eq_params, eq_params, state, xm, 960,
                    spatial_enabled=True, eq_enabled=True,
                    eq_crossfading=False, operands=operands)
                outs.append(y)
        return torch.cat(outs, dim=-1).cpu().numpy()


def worst_lane_error(got, x, hrirs, designs, N: int, G: int) -> float:
    """The worst lane's rel-RMS against the float64 oracles of its own
    group's bank (UPOLSOracle per speaker and ear, summed over speakers)
    and EQ (EqCascadeOracle)."""
    from airwave_tpu_torch.oracle.eq_oracle import EqCascadeOracle
    from airwave_tpu_torch.oracle.upols_oracle import UPOLSOracle

    B, S = got.shape[0], x.shape[1]
    worst = 0.0
    for b in range(B):
        g = b // (B // G)  # lane's profile group (contiguous segments)
        ref = np.zeros((2, N * T))
        for s in range(S):
            for e in range(2):
                oracle = UPOLSOracle(hrirs[g][s, e], T)
                ref[e] += np.concatenate(
                    [oracle.process(x[b, s, i * T:(i + 1) * T])
                     for i in range(N)])
        preamp, coeffs = designs[g]
        eq_oracle = EqCascadeOracle(coeffs, preamp, SAMPLE_RATE)
        rl, rr = eq_oracle.process(ref[0].astype(np.float32),
                                   ref[1].astype(np.float32))
        ref = np.stack([rl, rr])
        err = float(np.sqrt(np.mean((got[b] - ref) ** 2))
                    / np.sqrt(np.mean(ref ** 2)))
        worst = max(worst, err)
    return worst


def validate(argv=None) -> dict:
    """Parse `argv`, run the chain and return the result line's fields."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.pool_groups < 1:
        parser.error("--pool-groups must be >= 1")
    if args.pool_groups > 1 and not args.pool:
        parser.error("--pool-groups requires --pool")
    if args.batch % args.pool_groups:
        parser.error("--batch must divide by --pool-groups")
    hrir_seconds = _hrir_seconds(parser, args)

    import torch

    from airwave_tpu_torch.assets.channel_maps import detect_layout
    from airwave_tpu_torch.device import (apply_precision_policy,
                                          precision_stamp, resolve_device)
    from airwave_tpu_torch.ops import fftmm

    dev = resolve_device(args.device)
    apply_precision_policy()
    G = args.pool_groups
    layout = detect_layout(args.speakers)
    hrirs, eq_defs, designs = _profiles(G, hrir_seconds, layout)
    B, N, S = args.batch, args.blocks, args.speakers
    # Multi-block paths consume whole M-block steps: round the block count
    # up instead of dying on an indivisible mix of --blocks and
    # --blocks-per-step.
    N += (-N) % args.blocks_per_step
    x = (np.random.default_rng(0).standard_normal((B, S, N * T))
         * 0.3).astype(np.float32)
    if args.pool:
        got = _run_pool(args, dev, hrirs, eq_defs, x, N)
    else:
        got = _run_chain(args, dev, hrirs[0], designs[0], x, N)
    worst = worst_lane_error(got, x, hrirs, designs, N, G)

    result = {
        "metric": "chain rel RMS vs float64 oracle",
        "value": worst,
        "target": args.contract,
        "pass": worst <= args.contract,
        "matmul_precision": fftmm.PRECISION,
        "dft_precision": fftmm.DFT_PRECISION,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "pool": bool(args.pool),
        "pool_groups": G,
        "blocks_per_step": args.blocks_per_step,
        "speakers": S,
        "layout": layout.name,
        "batch": B,
        "blocks": N,
        **precision_stamp(),
    }
    if hrir_seconds is not None:
        result["hrir_seconds_per_group"] = hrir_seconds
    return result


def main(argv=None) -> int:
    result = validate(argv)
    print(json.dumps(result), flush=True)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    sys.exit(main())
