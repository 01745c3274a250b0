"""Headless application shell: the port's user-facing CLI.

Port of airwave_tpu/shell/app.py with the same subcommands, flags and JSON
output, on the card by default:

  render   offline bake: input WAV(s) -> HRIR (+EQ) -> stereo WAV(s)
  presets  seed / list / import the managed preset libraries
  demo     run the FULL runtime (controller + verification + recovery) on a
           synthetic transport and report the status trail
  serve    TCP streaming render server (one profile, or grouped with
           repeated --profile HRIR.wav[:EQ.txt])
  client   stream a WAV through a running server (deployment smoke check)
  status   environment and device summary

`python -m airwave_tpu_torch <command> ...` (or the `airwave-tpu-torch`
console script). `--device` names the torch device (default cuda:0) and
`--cpu` means `--device cpu`; nothing falls back to the CPU when the card
is missing (`presets` takes them too, for the HRIR library's renderers).
`serve --mesh-devices N` shards the pool's lanes over the first N cards
(with `--cpu`, over N virtual shards of the CPU).

Two deliberate differences from the JAX CLI: restore_serve_checkpoint
moves aside ANY unreadable checkpoint (truncated, empty leaves, bad header)
and starts fresh, where the JAX one catches only ValueError and KeyError
and lets a truncated raw file's IndexError crash-loop the server; and
`serve` prints its listening line inside the SIGINT handler's reach, where
a SIGINT right after the JAX line kills the server before its checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

def _default_data_dir() -> str:
    return os.environ.get(
        "AIRWAVE_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".airwave_tpu"),
    )


def _device(args) -> str:
    return "cpu" if getattr(args, "cpu", False) else getattr(
        args, "device", "cuda:0")


def _load_equalizer(path: Optional[str]):
    """Parse an EqualizerAPO preset for the render/serve CLIs.

    EQ failures are NON-FATAL on the processing chain (the reference
    graph's contract): a preset that fails to parse warns with its
    line-numbered issues and the render continues spatial-only, same as a
    preset that parses but fails coefficient design."""
    if path is None:
        return None
    from airwave_tpu_torch.io import apo
    from airwave_tpu_torch.utils.errors import EqualizerParseError

    with open(path, "rb") as f:
        data = f.read()
    try:
        return apo.parse(data, os.path.basename(path))
    except EqualizerParseError as err:
        print(f"warning: equalizer disabled: {err}", file=sys.stderr)
        return None


def cmd_render(args) -> int:
    from airwave_tpu_torch.assets import channel_maps as cm
    from airwave_tpu_torch.graph.effect_graph import AudioEffectGraph
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.graph.spatial_effect import SpatialEffect
    from airwave_tpu_torch.io import wav as wav_io
    from airwave_tpu_torch.utils.profiling import RenderProfiler

    device = _device(args)
    inputs = [wav_io.load(p) for p in args.input]
    rate = inputs[0].sample_rate
    channels = inputs[0].channel_count
    for path, data in zip(args.input, inputs):
        if data.sample_rate != rate or data.channel_count != channels:
            raise SystemExit(
                f"{path}: all inputs must share rate/channels in one bake"
            )
    layout = cm.detect_layout(channels) if channels > 1 else cm.STEREO

    hrir = wav_io.load(args.hrir)
    batch = len(inputs)
    definition = _load_equalizer(args.eq)
    eq_active = definition is not None
    graph = None
    if not args.throughput:
        renderer = prepare_renderer(hrir, layout, rate, args.block_size,
                                    device=device)
        spatial = SpatialEffect(batch=batch, sample_rate=rate,
                                block_size=args.block_size, device=device)
        spatial.set_renderer(renderer)
        graph = AudioEffectGraph(spatial, batch=batch, device=device)
        result = graph.prepare(rate, definition)
        if result.equalizer_warning is not None:
            print(f"warning: {result.equalizer_warning}", file=sys.stderr)
            eq_active = False

    frames = max(d.frame_count for d in inputs)
    block = args.block_size
    padded = ((frames + block - 1) // block) * block
    x = np.zeros((batch, max(channels, 2), padded), np.float32)
    for i, data in enumerate(inputs):
        audio = data.audio
        if audio.shape[0] == 1:
            audio = np.repeat(audio, 2, axis=0)
        x[i, : audio.shape[0], : data.frame_count] = audio

    profiler = RenderProfiler(rate, block, batch)
    if args.throughput:
        # The lookahead bake: 8 blocks per delay-line read, the whole
        # signal on the device (models/bake.bake, blocks_per_step=8). Unlike
        # the graph path, the EQ applies from sample 0 with no activation
        # ramp (the graph path plays the reference's 20 ms unity->target
        # ramp).
        from airwave_tpu_torch.graph.renderer import build_hrir_time_domain
        from airwave_tpu_torch.models.bake import bake as bake_fn
        from airwave_tpu_torch.ops import biquad_design as bd

        hrir_td, _speakers, mapped = build_hrir_time_domain(
            hrir, layout, rate, with_speakers=True
        )
        if x.shape[1] != hrir_td.shape[0]:
            # Unmapped layout channels (e.g. 7.1.4 heights vs a height-less
            # map) drop here, same as the graph path.
            x = x[:, list(mapped)]
        preamp, coeffs = 1.0, None
        if definition is not None:
            # EQ preparation failures stay NON-FATAL warnings here too
            # (the graph path's contract, AudioEffectGraph.swift:103-137).
            try:
                preamp, coeffs = bd.design_cascade(definition, rate)
            except Exception as exc:  # noqa: BLE001 — non-fatal contract
                print(f"warning: equalizer disabled: {exc}", file=sys.stderr)
                eq_active = False
        t0 = time.perf_counter()
        y, _ = bake_fn(hrir_td, x, rate, coeffs, preamp, block_size=block,
                       blocks_per_step=8, device=device)
        elapsed = time.perf_counter() - t0
        profile_report = {
            "mode": "throughput",
            "seconds": elapsed,
            "realtime_multiple": (batch * padded / rate) / max(elapsed, 1e-9),
        }
    else:
        outs = []
        for i in range(padded // block):
            with profiler.step():
                outs.append(graph.process(x[:, :, i * block:(i + 1) * block]))
        y = np.concatenate(outs, axis=-1)
        profile_report = profiler.report()

    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for i, src in enumerate(args.input):
        stem = os.path.splitext(os.path.basename(src))[0]
        out_path = os.path.join(args.output_dir, f"{stem}.binaural.wav")
        # Block-aligned pushes drain with zero adapter lag; trim the padding.
        wav_io.save(out_path, y[i, :, : inputs[i].frame_count], rate)
        written.append(out_path)

    print(json.dumps({
        "rendered": written,
        "sample_rate": rate,
        "layout": layout.name,
        "equalizer": eq_active,
        "device": device,
        "profile": profile_report,
    }, indent=2))
    return 0


def cmd_presets(args) -> int:
    from airwave_tpu_torch.assets import bundled
    from airwave_tpu_torch.assets.eq_library import EqualizerManager
    from airwave_tpu_torch.assets.hrir_library import HRIRManager

    base = args.data_dir
    eq = EqualizerManager(os.path.join(base, "eq"))
    hrir = HRIRManager(os.path.join(base, "hrir"), device=_device(args))

    if args.presets_command == "seed":
        bundled.seed_bundled_presets(eq, hrir, os.path.join(base, "staging"))
        print(f"seeded {len(eq.presets())} EQ + {len(hrir.presets())} HRIR "
              f"presets into {base}")
        return 0
    if args.presets_command == "list":
        for preset in hrir.presets():
            print(f"hrir  {preset.id[:8]}  {preset.display_name}  "
                  f"{preset.channel_count}ch@{preset.sample_rate:.0f}")
        for preset in eq.presets():
            print(f"eq    {preset.id[:8]}  {preset.display_name}")
        return 0
    if args.presets_command == "import":
        failures = 0
        for path in args.files:
            try:
                if path.lower().endswith(".wav"):
                    preset = hrir.import_preset(path)
                else:
                    preset = eq.import_preset(path)
                print(f"imported {preset.display_name} ({preset.id[:8]})")
            except Exception as err:  # noqa: BLE001
                failures += 1
                print(f"FAIL {path}: {err}", file=sys.stderr)
        return 1 if failures else 0
    return 2


def build_demo(data_dir: str, device: str, eq_preset: Optional[str] = None):
    """Seed the bundled presets into `data_dir` and wire cmd_demo's runtime
    on `device`: SyntheticTransport -> AudioRuntimeController ->
    StreamPipeline(transport, graph.process) -> AudioEffectGraph(
    SpatialEffect(batch=1)), the coordinators, and the synthetic output's
    profile bound to the Neutral HRIR and the first EQ preset whose name
    contains `eq_preset`. Nothing is launched. Returns the objects by name
    (the pipeline factory reads `graph.process` at each start)."""
    import types

    from airwave_tpu_torch.assets import bundled
    from airwave_tpu_torch.assets.eq_library import EqualizerManager
    from airwave_tpu_torch.assets.hrir_library import HRIRManager
    from airwave_tpu_torch.assets.profiles import DeviceProfileManager
    from airwave_tpu_torch.assets.store import JSONStore
    from airwave_tpu_torch.graph.effect_graph import AudioEffectGraph
    from airwave_tpu_torch.graph.spatial_effect import SpatialEffect
    from airwave_tpu_torch.runtime.controller import AudioRuntimeController
    from airwave_tpu_torch.runtime.coordinators import (
        DeviceProfileRuntimeCoordinator,
        OutputDeviceDiscoveryCoordinator,
    )
    from airwave_tpu_torch.runtime.pipeline import StreamPipeline
    from airwave_tpu_torch.runtime.scheduler import ManualScheduler
    from airwave_tpu_torch.runtime.state import AudioRuntimeState
    from airwave_tpu_torch.runtime.synthetic_transport import (
        SyntheticTransport,
    )
    from airwave_tpu_torch.runtime.transport import OutputDeviceDescriptor

    eq = EqualizerManager(os.path.join(data_dir, "eq"))
    hrir = HRIRManager(os.path.join(data_dir, "hrir"), device=device)
    bundled.seed_bundled_presets(eq, hrir, os.path.join(data_dir, "staging"))
    profiles = DeviceProfileManager(
        JSONStore(os.path.join(data_dir, "profiles.json")))

    output = OutputDeviceDescriptor(uid="synthetic-out", name="Synthetic",
                                    nominal_sample_rate=48_000.0)
    transport = SyntheticTransport(output)
    scheduler = ManualScheduler()
    state = AudioRuntimeState()
    trail: List[str] = []
    state.observe(lambda s: trail.append(s.status.value))

    spatial = SpatialEffect(batch=1, sample_rate=48_000.0, device=device)
    graph = AudioEffectGraph(spatial, device=device)
    controller = AudioRuntimeController(
        transport=transport,
        pipeline_factory=lambda: StreamPipeline(transport, graph.process),
        effect_graph=graph,
        state=state,
        scheduler=scheduler,
    )
    coordinator = DeviceProfileRuntimeCoordinator(
        profiles, hrir, eq, controller, spatial
    )
    OutputDeviceDiscoveryCoordinator(transport, profiles).launch()

    neutral = next((p for p in hrir.presets() if "Neutral" in p.display_name),
                   None)
    if neutral is not None:
        profiles.set_hrir_preset_id(output.uid, neutral.id)
    eq_applied = None
    if eq_preset:
        match = next((p for p in eq.presets()
                      if eq_preset.lower() in p.display_name.lower()),
                     None)
        if match is not None:
            profiles.set_equalizer_preset_id(output.uid, match.id)
            eq_applied = match.display_name
        else:
            print(f"warning: no bundled EQ preset matches "
                  f"{eq_preset!r}; running without EQ", file=sys.stderr)
    return types.SimpleNamespace(
        eq=eq, hrir=hrir, profiles=profiles, output=output,
        transport=transport, scheduler=scheduler, state=state, trail=trail,
        spatial=spatial, graph=graph, controller=controller,
        coordinator=coordinator, eq_applied=eq_applied)


def cmd_demo(args) -> int:
    from airwave_tpu_torch.shell.presentation import present_status

    device = _device(args)
    demo = build_demo(args.data_dir, device, args.eq_preset)
    demo.coordinator.launch()
    block = 512
    total_blocks = int(args.seconds * 48_000 / block)
    peak = 0.0
    for _ in range(total_blocks):
        out = demo.transport.pump(block)
        if out is not None:
            peak = max(peak, float(np.max(np.abs(out))))
        demo.scheduler.advance(block / 48_000.0)

    presentation = present_status(demo.state)
    print(json.dumps({
        "status": demo.state.status.value,
        "title": presentation.title,
        "severity": presentation.severity,
        "health": list(presentation.health_lines),
        "status_trail": demo.trail[-12:],
        "frames_pumped": demo.transport.frames_pumped,
        "spatial_ready": demo.spatial.is_ready,
        "equalizer_preset": demo.eq_applied,
        "output_peak": round(peak, 4),
        "device": device,
    }, indent=2))
    return 0


def build_serve_pool(args):
    """Resolve serve-CLI args into a prewarmed StreamPool on the args'
    device (cmd_serve wraps it in the server): one profile from --hrir and
    --eq, or a grouped pool of one group per --profile HRIR.wav[:EQ.txt],
    in order (clients pick theirs with {"group": G})."""
    from airwave_tpu_torch.assets import channel_maps as cm
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.io import wav as wav_io
    from airwave_tpu_torch.runtime.stream_pool import PoolProfile, StreamPool

    specs = getattr(args, "profile", None) or []
    if specs and (args.hrir or args.eq):
        raise SystemExit("pass either --hrir/--eq or --profile, not both")
    if not specs and not args.hrir:
        raise SystemExit("one of --hrir or --profile is required")
    layout = {"stereo": cm.STEREO, "7.1": cm.SURROUND_7_1,
              "7.1.4": cm.ATMOS_7_1_4}[args.layout]
    blocks_per_step = getattr(args, "blocks_per_step", 1) or 1
    device = _device(args)
    mesh = serve_mesh(args, device)

    def prepare(path: str):
        return prepare_renderer(wav_io.load(path), layout, args.sample_rate,
                                lookahead=blocks_per_step, device=device)

    kwargs = {}
    if specs:
        parsed = [spec.partition(":")[::2] for spec in specs]
        # One load and one preparation per unique HRIR path (tenants often
        # share a bank and differ in EQ). Differing HRIR lengths need no
        # alignment: each group carries its own delay line.
        renderers = {h: prepare(h) for h in dict.fromkeys(h for h, _ in parsed)}
        kwargs["profiles"] = [
            PoolProfile(renderers[h], _load_equalizer(eq or None))
            for h, eq in parsed]
    else:
        kwargs.update(renderer=prepare(args.hrir),
                      eq_definition=_load_equalizer(args.eq))
    pool = StreamPool(
        max_streams=args.max_streams,
        sample_rate=args.sample_rate,
        blocks_per_step=blocks_per_step,
        device=None if mesh else device,
        mesh=mesh,
        **kwargs,
    )
    # Load every round's kernels and cuBLAS paths before accepting traffic,
    # the crossfaded hot-swap rounds included: RenderServer.set_renderer
    # crossfades by default.
    pool.prewarm(include_hotswap=True)
    return pool, layout


def serve_mesh(args, device: str):
    """The serve pool's streams mesh for --mesh-devices N (None without the
    flag): cuda:0 ... cuda:N-1, or with --cpu N virtual shards of the CPU,
    with the JAX CLI's two errors."""
    n = getattr(args, "mesh_devices", 0) or 0
    if not n:
        return None
    import torch

    from airwave_tpu_torch.parallel.mesh import make_mesh

    if torch.device(device).type == "cpu":
        devices = ["cpu"] * n
    else:
        visible = torch.cuda.device_count()
        if visible < n:
            raise SystemExit(f"--mesh-devices {n}: only {visible} devices "
                             f"visible")
        devices = [f"cuda:{i}" for i in range(n)]
    if args.max_streams % n:
        raise SystemExit(f"--max-streams {args.max_streams} must divide by "
                         f"--mesh-devices {n}")
    return make_mesh(devices)


def restore_serve_checkpoint(ckpt: Optional[str], pool):
    """Restore a serve checkpoint into `pool`; returns
    (resumed: bool, orphan_tokens: dict | None,
    orphan_aliases: dict | None — old lane id -> new, set after a resize).

    A checkpoint that cannot be restored must not crash-loop the server:
    an incompatible one (another pool shape, another schema) and an
    unreadable one (truncated, empty, a bad header) alike degrade to a
    fresh start, and the file is moved aside to `<path>.incompatible`
    (never silently overwritten or deleted). The pool is unchanged then:
    load_pool_snapshot and StreamPool.restore check everything first.

    A checkpoint written at a different --max-streams resizes on load:
    attached lanes keep their exact history, compacted into the new lane
    space, and their resume tokens are remapped; clients still hold the
    old lane id, which the server translates during the grace window.
    Checkpoints of the JAX package's serve restore here too."""
    if not ckpt:
        return False, None, None
    from airwave_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    load_pool_snapshot,
                                                    snapshot_lane_count)

    if not os.path.exists(checkpoint_path(ckpt)):
        return False, None, None
    try:
        written_lanes = snapshot_lane_count(ckpt)
        if written_lanes != pool.max_streams:
            snap = load_pool_snapshot(ckpt, pool, lanes=written_lanes)
            lane_map = pool.restore(snap, resize=True) or {}
            tokens = snap.get("resume_tokens", {}) or {}
            snap["resume_tokens"] = {
                lane_map[s]: tok for s, tok in tokens.items()
                if s in lane_map
            }
            snap["resume_aliases"] = {
                int(s_old): int(s_new) for s_old, s_new in lane_map.items()
            }
            print(json.dumps({
                "checkpoint_resized": {
                    "from_max_streams": written_lanes,
                    "to_max_streams": pool.max_streams,
                    "lanes_kept": len(lane_map),
                },
            }), flush=True)
        else:
            snap = load_pool_snapshot(ckpt, pool)
            pool.restore(snap)
    except (ValueError, KeyError, IndexError, TypeError) as exc:
        aside = checkpoint_path(ckpt) + ".incompatible"
        os.replace(checkpoint_path(ckpt), aside)
        print(json.dumps({"checkpoint_incompatible": str(exc),
                          "moved_to": aside}), flush=True)
        return False, None, None
    # Always a dict when restored: even a token-less checkpoint's restored
    # lanes are dead connections that must grace-expire.
    return (True, snap.get("resume_tokens", {}) or {},
            snap.get("resume_aliases") or None)


def cmd_serve(args) -> int:
    from airwave_tpu_torch.shell.serve import RenderServer

    pool, layout = build_serve_pool(args)
    ckpt = getattr(args, "checkpoint", None)
    resumed, orphan_tokens, orphan_aliases = restore_serve_checkpoint(
        ckpt, pool)
    server = RenderServer(pool, host=args.host, port=args.port,
                          resume_grace=getattr(args, "resume_grace", 30.0),
                          orphan_tokens=orphan_tokens,
                          orphan_aliases=orphan_aliases,
                          io_mode=getattr(args, "io_mode", "selector"))
    server.start()
    interval = getattr(args, "stats_interval", 0.0) or 0.0
    next_stats = time.monotonic() + interval if interval > 0 else None
    ckpt_interval = getattr(args, "checkpoint_interval", 30.0) or 0.0
    next_ckpt = (time.monotonic() + ckpt_interval
                 if ckpt and ckpt_interval > 0 else None)
    poll = min(1.0, interval) if interval > 0 else 1.0
    try:
        # Printed inside the handler's reach: a caller that sends SIGINT
        # as soon as it reads this line gets the checkpoint and exit 0.
        print(json.dumps({"listening": list(server.address),
                          "max_streams": args.max_streams,
                          "layout": layout.name,
                          "device": str(pool.device),
                          "mesh_devices": getattr(args, "mesh_devices", 0) or 1,
                          "blocks_per_step": pool.blocks_per_step,
                          "profile_groups": pool.groups,
                          "restored_checkpoint": resumed,
                          "resumable_lanes": len(server._orphans)}),
              flush=True)
        while True:
            time.sleep(poll)
            now = time.monotonic()
            if next_stats is not None and now >= next_stats:
                print(json.dumps({"stats": server.stats()}), flush=True)
                next_stats = now + interval
            if next_ckpt is not None and now >= next_ckpt:
                server.save_checkpoint(ckpt)
                next_ckpt = now + ckpt_interval
    except KeyboardInterrupt:
        if ckpt:
            server.save_checkpoint(ckpt)
            print(json.dumps({"checkpoint_saved": ckpt}), flush=True)
        server.stop()
    return 0


def cmd_client(args) -> int:
    """Stream a WAV through a running RenderServer and write the result.

    The ops-side counterpart of `serve`: smoke-checks a deployment end to
    end (socket -> rings -> device -> socket); this process needs no torch.
    Exit 1 if the server truncated the stream (its EOF frame is the
    completion guarantee, shell/serve.py)."""
    from airwave_tpu_torch.io import wav as wav_io
    from airwave_tpu_torch.shell.wire_client import render_via_server

    data = wav_io.load(args.input)
    audio = data.audio.astype(np.float32)
    error = None
    try:
        out = render_via_server((args.host, args.port), audio,
                                chunk=args.chunk, group=args.group)
    except OSError as err:
        # The smoke check's contract is a JSON report + exit 1 on
        # truncation: a mid-stream server death is exactly that.
        out = np.zeros((2, 0), np.float32)
        error = f"{type(err).__name__}: {err}"
    truncated = out.shape[1] < audio.shape[1]
    if out.shape[1]:
        wav_io.save(args.output, out, data.sample_rate)
    result = {
        "input_frames": int(audio.shape[1]),
        "rendered_frames": int(out.shape[1]),
        "sample_rate": data.sample_rate,
        "channels_in": int(audio.shape[0]),
        "group": args.group,
        "truncated": truncated,
        "output": args.output if out.shape[1] else None,
    }
    if error is not None:
        result["error"] = error
    print(json.dumps(result))
    return 1 if truncated else 0


def cmd_status(args) -> int:
    import torch

    from airwave_tpu_torch import native
    from airwave_tpu_torch.device import resolve_device

    device = resolve_device(_device(args))
    try:
        native.load_library()
        assembler = True
    except native.AssemblerBuildError:
        assembler = False
    cards = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    print(json.dumps({
        "package": "airwave_tpu_torch",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(device),
        "devices": ["cpu", *cards],
        "native_assembler": assembler,
        "data_dir": args.data_dir,
    }, indent=2))
    return 0


def _device_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0, the card)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (same as --device cpu)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="airwave_tpu_torch",
        description="spatial-audio rendering on PyTorch/CUDA",
    )
    parser.add_argument("--data-dir", default=_default_data_dir())
    sub = parser.add_subparsers(dest="command", required=True)

    render = sub.add_parser("render", help="offline binaural bake")
    render.add_argument("--input", action="append", required=True)
    render.add_argument("--output-dir", required=True)
    render.add_argument("--hrir", required=True, help="HRIR WAV path")
    render.add_argument("--eq", help="EqualizerAPO preset path")
    render.add_argument("--block-size", type=int, default=512)
    _device_flags(render)
    render.add_argument("--throughput", action="store_true",
                        help="device-resident lookahead bake (fastest for "
                             "long renders; EQ applies from sample 0 with "
                             "no 20 ms activation ramp)")
    render.set_defaults(fn=cmd_render)

    presets = sub.add_parser("presets", help="manage preset libraries")
    _device_flags(presets)
    presets_sub = presets.add_subparsers(dest="presets_command", required=True)
    presets_sub.add_parser("seed")
    presets_sub.add_parser("list")
    imp = presets_sub.add_parser("import")
    imp.add_argument("files", nargs="+")
    presets.set_defaults(fn=cmd_presets)

    demo = sub.add_parser("demo", help="run the full runtime on a synthetic "
                                       "transport")
    demo.add_argument("--seconds", type=float, default=1.0)
    demo.add_argument("--eq-preset", help="bundled EQ preset name substring")
    _device_flags(demo)
    demo.set_defaults(fn=cmd_demo)

    serve = sub.add_parser("serve", help="TCP streaming render server")
    serve.add_argument("--hrir", help="HRIR WAV (single-profile pool)")
    serve.add_argument("--eq")
    serve.add_argument("--profile", action="append",
                       help="HRIR.wav[:EQ.txt], repeatable: serve a grouped "
                            "multi-tenant pool, one profile group per flag "
                            "in order (clients pick theirs with client "
                            "--group); excludes --hrir/--eq")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=7711)
    serve.add_argument("--sample-rate", type=float, default=48_000.0)
    serve.add_argument("--layout", choices=["stereo", "7.1", "7.1.4"],
                       default="stereo")
    serve.add_argument("--max-streams", type=int, default=64)
    serve.add_argument("--mesh-devices", type=int, default=0,
                       help="shard the pool's lanes over this many devices "
                            "(cuda:0 ... cuda:N-1; with --cpu, N virtual "
                            "shards of the CPU); --max-streams must divide "
                            "by N; 0 = one device")
    serve.add_argument("--blocks-per-step", type=int, default=1,
                       help="throughput tier: render M blocks per lane per "
                            "round on the paged lookahead path (+up to M "
                            "blocks of latency; 1 = the zero-added-latency "
                            "default)")
    serve.add_argument("--checkpoint",
                       help="serving checkpoint path: saved every "
                            "--checkpoint-interval seconds (and on "
                            "Ctrl-C); if the file exists at startup the "
                            "pool restores from it and restored lanes "
                            "become resumable for --resume-grace seconds "
                            '(clients reconnect with {"resume": LANE})')
    serve.add_argument("--checkpoint-interval", type=float, default=30.0)
    serve.add_argument("--resume-grace", type=float, default=30.0,
                       help="seconds a restored lane stays claimable "
                            "before it is detached")
    serve.add_argument("--io-mode", choices=["selector", "thread"],
                       default="selector",
                       help="data plane: 'selector' (one epoll IO thread, "
                            "the O(1000)-connection path, default) or "
                            "'thread' (thread-per-connection)")
    serve.add_argument("--stats-interval", type=float, default=0.0,
                       help="seconds between JSON stats lines on stdout "
                            "(0 = off): server counters + pool occupancy/"
                            "rounds/errors")
    _device_flags(serve)
    serve.set_defaults(fn=cmd_serve)

    client = sub.add_parser("client",
                            help="stream a WAV through a running render "
                                 "server (deployment smoke check)")
    client.add_argument("--input", required=True, help="input WAV path")
    client.add_argument("--output", required=True, help="rendered WAV path")
    client.add_argument("--host", default="127.0.0.1")
    client.add_argument("--port", type=int, default=7711)
    client.add_argument("--group", type=int, default=0,
                        help="profile group on a grouped pool")
    client.add_argument("--chunk", type=int, default=1024,
                        help="frames per wire message")
    client.set_defaults(fn=cmd_client)

    status = sub.add_parser("status", help="environment and device summary")
    _device_flags(status)
    status.set_defaults(fn=cmd_status)
    return parser


def install_cli_signal_handlers() -> None:
    """Process-entry signal setup: die quietly on SIGPIPE like a unix tool
    when piped into head etc. Called by cli() only: flipping the
    process-wide disposition from a library call would make every socket
    peer-close fatal to the embedding process."""
    import signal

    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


def cli(argv: Optional[List[str]] = None) -> int:
    """Process entry point (console script and python -m): installs the
    unix-tool signal handlers for the short-lived subcommands, then
    dispatches. `serve` keeps Python's default SIGPIPE=ignore: with SIG_DFL
    a client disconnecting mid-sendall would kill the whole serving
    process instead of raising the per-connection BrokenPipeError it
    handles."""
    args = build_parser().parse_args(argv)
    if args.command != "serve":
        install_cli_signal_handlers()
    return args.fn(args)
