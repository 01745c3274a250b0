"""The port's coordinators and its `presets` and `demo` CLI against the JAX
package's.

The coordinator cases of tests/test_coordinators.py run on each package's
own wiring (RecordingTransport -> AudioRuntimeController ->
StreamPipeline -> AudioEffectGraph(SpatialEffect) with the profile,
HRIR and EQ libraries; the port's on device="cpu"), with the same preset
ids. Each wiring keeps the JAX test's assertions; the status trails,
health issues and transport events must be equal, every block the effect
graph renders must match the JAX wiring's within rel-RMS 1e-5, and both
must match a float64 reference within 1e-5: scipy fftconvolve of the
graph's recorded input with the active bank (a crossfaded swap blends
both banks per sample), then the EQ cascade by sosfilt, each EQ
publication ramping over 20 ms from what was heard to its cascade started
from rest. Then `presets seed|list|import` and `demo --cpu` through the
port's `main`, whose output must equal the JAX CLI's.
"""

import importlib
import json
import types
import uuid

import numpy as np
import pytest
import torch
from scipy.signal import fftconvolve, sosfilt

from airwave_tpu.shell.app import main as jax_main
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import build_hrir_time_domain
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.shell.app import main as torch_main

_MODULES = {
    "eq_library": "assets.eq_library",
    "hrir_library": "assets.hrir_library",
    "profiles": "assets.profiles",
    "store": "assets.store",
    "effect_graph": "graph.effect_graph",
    "spatial_effect": "graph.spatial_effect",
    "wav": "io.wav",
    "controller": "runtime.controller",
    "coordinators": "runtime.coordinators",
    "fakes": "runtime.fakes",
    "pipeline": "runtime.pipeline",
    "scheduler": "runtime.scheduler",
    "state": "runtime.state",
    "transport": "runtime.transport",
}

CHAIN_TOL = 1e-5   # rel-RMS, the BASELINE.md chain contract
FADE = 960         # the 20 ms crossfade at 48 kHz, in samples
RATE = 48_000.0
EQ_TEXT = "Preamp: -3 dB\nFilter 1: ON PK Fc 100 Hz Gain 2 dB Q 1\n"


def _package(root: str) -> types.SimpleNamespace:
    P = types.SimpleNamespace(**{
        key: importlib.import_module(f"{root}.{name}")
        for key, name in _MODULES.items()})
    P.on_cpu = {"device": "cpu"} if root == "airwave_tpu_torch" else {}
    return P


PACKAGES = {"jax": _package("airwave_tpu"),
            "torch": _package("airwave_tpu_torch")}


def rel_rms(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


class World:
    """One package's wiring, as tests/test_coordinators.py:build_world
    builds it, with every effect-graph call's input and output recorded."""

    def __init__(self, P, root):
        self.P, self.root = P, root
        self.output = P.transport.OutputDeviceDescriptor(
            uid="dev-1", name="Speakers", nominal_sample_rate=RATE)
        self.transport = P.fakes.RecordingTransport(self.output)
        self.scheduler = P.scheduler.ManualScheduler()
        self.state = P.state.AudioRuntimeState()
        self.statuses = []
        self.state.observe(lambda s: self.statuses.append(s.status.value))
        self.profiles = P.profiles.DeviceProfileManager(
            P.store.JSONStore(str(root / "profiles.json")))
        self.eq = P.eq_library.EqualizerManager(str(root / "eq"))
        self.hrir = P.hrir_library.HRIRManager(str(root / "hrir"), **P.on_cpu)
        self.spatial = P.spatial_effect.SpatialEffect(
            batch=1, sample_rate=RATE, **P.on_cpu)
        self.graph = P.effect_graph.AudioEffectGraph(self.spatial, **P.on_cpu)
        self.calls = []
        process = self.graph.process

        def recorded(x):
            y = process(x)
            self.calls.append((np.array(x, np.float32), np.array(y)))
            return y

        self.graph.process = recorded
        self.controller = P.controller.AudioRuntimeController(
            transport=self.transport,
            pipeline_factory=lambda: P.pipeline.StreamPipeline(
                self.transport, self.graph.process),
            effect_graph=self.graph,
            state=self.state,
            scheduler=self.scheduler,
            probe_player=P.fakes.ProbePlayerFake(),
        )
        self.coordinator = P.coordinators.DeviceProfileRuntimeCoordinator(
            self.profiles, self.hrir, self.eq, self.controller, self.spatial)

    def hrir_file(self, name, frames, rate, seed, scale):
        rng = np.random.default_rng(seed)
        audio = (rng.standard_normal((14, frames)) * scale).astype(np.float32)
        path = self.root / name
        self.P.wav.save(str(path), audio, rate)
        return str(path)

    def seed_presets(self):
        hrir_preset = self.hrir.import_preset(
            self.hrir_file("set.wav", 128, 48_000, 0, 0.1))
        (self.root / "p.txt").write_text(EQ_TEXT)
        return hrir_preset, self.eq.import_preset(str(self.root / "p.txt"))

    def verify_capture(self):
        return self.transport.drive_callback(
            np.full((1, 2, 4096), 0.5, np.float32))

    def drive(self, seed, blocks=4, n=512):
        rng = np.random.default_rng(seed)
        for _ in range(blocks):
            y = self.transport.drive_callback(
                (rng.standard_normal((1, 2, n)) * 0.2).astype(np.float32))
            assert np.all(np.isfinite(y)) and y.shape == (1, 2, n)

    @property
    def frames(self) -> int:
        return sum(x.shape[-1] for x, _ in self.calls)

    def trace(self):
        return (self.statuses,
                [(i.category.name, i.message)
                 for i in self.state.health_issues],
                self.transport.events,
                [x.shape for x, _ in self.calls],
                self.spatial.is_ready, self.graph.equalizer_active,
                self.hrir.active_preset_id)


def bank_of(path):
    """The stereo renderer's time-domain bank [S, E, taps] at 48 kHz."""
    from airwave_tpu_torch.io import wav

    return build_hrir_time_domain(wav.load(str(path)), tcm.STEREO, RATE)


def reference(x, spatial_events, eq_events):
    """float64 output of the graph for its recorded input x [2, n].

    spatial_events: (sample, bank or None) in order; a bank after a bank
    is the coordinator's crossfaded swap (two set_renderer calls before
    the next block, so the fade restarts once from the lerped bank at
    ramp 1/FADE), a bank after none starts from an empty history.
    eq_events: (sample, (preamp, coeffs) or None) publications of a
    running EQ, each ramping from what was heard to its cascade from
    rest."""
    x = x.astype(np.float64)
    n = x.shape[-1]

    def conv(h, start):
        out = np.zeros((2, n))
        for e in range(2):
            out[e, start:] = sum(fftconvolve(x[s, start:], h[s, e])[:n - start]
                                 for s in range(h.shape[0]))
        return out

    y, current, origin = x.copy(), None, 0
    for t, h in spatial_events:
        if h is None:
            y[:, t:], current = x[:, t:], None
            continue
        if current is None:
            origin = t
            y[:, t:] = conv(h, t)[:, t:]
        else:
            r = np.minimum((np.arange(n - t) + 1.0) / FADE, 1.0)
            w_old = (1.0 - r) * (1.0 - 1.0 / FADE)
            y[:, t:] = (w_old * conv(current, origin)[:, t:]
                        + (1.0 - w_old) * conv(h, origin)[:, t:])
        current = h
    for t, design in eq_events:
        new = y.copy()
        if design is not None:
            preamp, coeffs = design
            sos = np.array([[c.b0, c.b1, c.b2, 1.0, c.a1, c.a2]
                            for c in coeffs])
            new[:, t:] = sosfilt(sos, preamp * y[:, t:], axis=-1)
        p = np.clip((np.arange(n) - t + 1.0) / FADE, 0.0, 1.0)
        y = (1.0 - p) * y + p * new  # untouched before t (p = 0 there)
    return y


def eq_design():
    from airwave_tpu_torch.io import apo

    return tbd.design_cascade(apo.parse(EQ_TEXT.encode(), "p.txt"), RATE)


# --- the coordinator cases ------------------------------------------------------


def discovery_pumps_inventory_into_profiles(w):
    P = w.P
    discovery = P.coordinators.OutputDeviceDiscoveryCoordinator(
        w.transport, w.profiles)
    discovery.launch()
    assert [t.device_uid for t in w.profiles.targets()
            if t.is_available] == ["dev-1"]
    assert w.profiles.profile("dev-1") is None
    w.transport.set_devices_for_test([
        w.output, P.transport.OutputDeviceDescriptor(uid="dev-2",
                                                     name="Headset")])
    assert sorted(t.device_uid for t in w.profiles.targets()
                  if t.is_available) == ["dev-1", "dev-2"]
    w.profiles.set_hrir_preset_id("dev-2", "some-preset")
    assert w.profiles.profile("dev-2").name == "Headset"
    return None


def prepare_activates_profile_presets(w):
    hrir_preset, eq_preset = w.seed_presets()
    w.profiles.set_hrir_preset_id(w.output.uid, hrir_preset.id)
    w.profiles.set_equalizer_preset_id(w.output.uid, eq_preset.id)
    w.coordinator.launch()
    w.verify_capture()
    assert w.state.status.value == "processing"
    assert w.spatial.is_ready and w.graph.equalizer_active
    assert w.hrir.active_preset_id == hrir_preset.id
    w.drive(1)
    return [(0, bank_of(w.root / "set.wav"))], [(0, eq_design())]


def prepare_without_profile_is_passthrough_ready(w):
    w.coordinator.launch()
    w.verify_capture()
    assert w.state.status.value == "processing"
    assert not w.spatial.is_ready and not w.graph.equalizer_active
    x = np.random.default_rng(0).standard_normal((1, 2, 64)).astype(
        np.float32)
    np.testing.assert_array_equal(w.transport.drive_callback(x), x)
    return [], []


def equalizer_profile_change_uses_live_fast_path(w):
    hrir_preset, eq_preset = w.seed_presets()
    w.profiles.set_hrir_preset_id(w.output.uid, hrir_preset.id)
    w.coordinator.launch()
    w.verify_capture()
    w.drive(2, blocks=2)
    t_eq = w.frames
    events_before = len(w.transport.events)
    w.profiles.set_equalizer_preset_id(w.output.uid, eq_preset.id)
    assert len(w.transport.events) == events_before  # no pipeline restart
    assert w.graph.equalizer_active
    assert w.state.status.value == "processing"
    w.drive(3)
    return [(0, bank_of(w.root / "set.wav"))], [(t_eq, eq_design())]


def hrir_profile_change_triggers_full_reprepare(w):
    hrir_preset, _ = w.seed_presets()
    w.coordinator.launch()
    w.verify_capture()
    w.drive(4, blocks=2)
    t_swap = w.frames
    events_before = len(w.transport.events)
    w.profiles.set_hrir_preset_id(w.output.uid, hrir_preset.id)
    assert len(w.transport.events) > events_before  # pipeline restarted
    assert w.hrir.active_preset_id == hrir_preset.id
    assert w.spatial.is_ready
    w.drive(5)
    return [(t_swap, bank_of(w.root / "set.wav"))], []


def preparation_deferred_until_library_ready(w):
    hrir_preset, _ = w.seed_presets()
    w.profiles.set_hrir_preset_id(w.output.uid, hrir_preset.id)
    w.coordinator.set_library_ready(False)
    w.coordinator.launch()
    assert w.state.status.value == "starting"
    assert w.controller.pipeline is None  # prepare held
    w.coordinator.set_library_ready(True)
    assert w.controller.pipeline is not None
    w.verify_capture()
    assert w.state.status.value == "processing"
    w.drive(6)
    return [(0, bank_of(w.root / "set.wav"))], []


def deleting_active_preset_clears_dangling_and_reprepares(w):
    hrir_preset, _ = w.seed_presets()
    w.profiles.set_hrir_preset_id(w.output.uid, hrir_preset.id)
    w.coordinator.launch()
    w.verify_capture()
    assert w.spatial.is_ready
    w.drive(7, blocks=2)
    t_del = w.frames
    w.hrir.delete_preset(hrir_preset.id)
    assert w.profiles.hrir_preset_id(w.output.uid) is None
    w.verify_capture()  # re-verify after the restart
    assert w.state.status.value == "processing"
    assert not w.spatial.is_ready  # fell back to passthrough
    w.drive(8, blocks=2)
    return [(0, bank_of(w.root / "set.wav")), (t_del, None)], []


def config4_rate_mismatched_hrir_resampled_at_activation(w):
    path = w.hrir_file("set441.wav", 441, 44_100, 3, 0.2)
    preset = w.hrir.import_preset(path)
    assert preset.sample_rate == 44_100
    w.profiles.set_hrir_preset_id(w.output.uid, preset.id)
    w.coordinator.launch()
    w.verify_capture()
    assert w.state.status.value == "processing"
    assert w.hrir.published_renderer.sample_rate == RATE
    w.drive(9, blocks=2)
    t_swap = w.frames
    native = w.hrir_file("set48.wav", 256, 48_000, 9, 0.2)
    preset2 = w.hrir.import_preset(native)
    w.profiles.set_hrir_preset_id(w.output.uid, preset2.id)
    w.verify_capture()  # a 4096-frame callback through the new pipeline
    assert w.state.status.value == "processing"
    w.drive(10)
    return [(0, bank_of(path)), (t_swap, bank_of(native))], []


COORDINATOR_CASES = [
    discovery_pumps_inventory_into_profiles,
    prepare_activates_profile_presets,
    prepare_without_profile_is_passthrough_ready,
    equalizer_profile_change_uses_live_fast_path,
    hrir_profile_change_triggers_full_reprepare,
    preparation_deferred_until_library_ready,
    deleting_active_preset_clears_dangling_and_reprepares,
    config4_rate_mismatched_hrir_resampled_at_activation,
]


@pytest.fixture
def same_ids(monkeypatch):
    """uuid.uuid4 from a counter that each package's run restarts."""
    counter = {"n": 0}

    def fake_uuid4():
        counter["n"] += 1
        return uuid.UUID(int=counter["n"])

    monkeypatch.setattr(uuid, "uuid4", fake_uuid4)
    return counter


@pytest.mark.parametrize("scenario", COORDINATOR_CASES,
                         ids=[s.__name__ for s in COORDINATOR_CASES])
def test_coordinators_match_jax_and_float64(scenario, tmp_path, same_ids):
    worlds, timelines = {}, {}
    for name, P in PACKAGES.items():
        same_ids["n"] = 0
        (tmp_path / name).mkdir()
        worlds[name] = World(P, tmp_path / name)
        timelines[name] = scenario(worlds[name])
    t, j = worlds["torch"], worlds["jax"]
    assert t.trace() == j.trace()
    if timelines["torch"] is None:
        return
    assert t.calls, "the graph rendered nothing"
    x = np.concatenate([c[0][0] for c in t.calls], -1)
    np.testing.assert_array_equal(
        x, np.concatenate([c[0][0] for c in j.calls], -1))
    y_t = np.concatenate([c[1][0] for c in t.calls], -1)
    y_j = np.concatenate([c[1][0] for c in j.calls], -1)
    assert rel_rms(y_t, y_j) <= CHAIN_TOL
    ref = reference(x, *timelines["torch"])
    assert rel_rms(y_t, ref) <= CHAIN_TOL
    assert rel_rms(y_j, ref) <= CHAIN_TOL


# --- the presets and demo CLI -------------------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr()


def test_presets_cli_matches_jax(tmp_path, capsys, same_ids):
    """seed, list and an import of a WAV, an EQ preset and a bad file, on
    the same ids: the same exit codes, output lines and manifests."""
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    from airwave_tpu_torch.io import wav

    wav.save(str(src / "Mine.wav"),
             (rng.standard_normal((14, 300)) * 0.1).astype(np.float32),
             48_000.0)
    (src / "Tilt.txt").write_text(EQ_TEXT)
    (src / "junk.txt").write_text("garbage directive\n")
    runs = {}
    for name, main, flags in (("jax", jax_main, []),
                              ("torch", torch_main, ["--cpu"])):
        same_ids["n"] = 0
        base = ["--data-dir", str(tmp_path / name)]
        runs[name] = [
            _cli(main, [*base, "presets", *flags, "seed"], capsys),
            _cli(main, [*base, "presets", *flags, "list"], capsys),
            _cli(main, [*base, "presets", *flags, "import",
                        str(src / "Mine.wav"), str(src / "Tilt.txt")],
                 capsys),
            _cli(main, [*base, "presets", *flags, "list"], capsys),
            _cli(main, [*base, "presets", *flags, "import",
                        str(src / "junk.txt")], capsys),
        ]
    for (rc_t, out_t), (rc_j, out_j) in zip(runs["torch"], runs["jax"]):
        assert rc_t == rc_j
        assert out_t.out.replace("/torch", "/jax") == out_j.out
    codes = [rc for rc, _ in runs["torch"]]
    assert codes == [0, 0, 0, 0, 1]
    listing = runs["torch"][3][1].out
    assert "Neutral" in listing and "Vocal Booster" in listing
    assert "Mine" in listing and "Tilt" in listing
    assert len(listing.splitlines()) == 3 + 5 + 2
    for sub in ("eq/manifest.json", "hrir/presets.json"):
        rows = [json.loads((tmp_path / name / sub).read_text())["presets"]
                for name in ("torch", "jax")]
        for table in rows:  # the wall-clock import times differ
            for row in table.values():
                assert row.pop("imported_at") > 0
        assert rows[0] == rows[1]


@pytest.mark.parametrize("eq_preset", [None, "Bass B"])
def test_demo_cli_matches_jax(tmp_path, capsys, eq_preset):
    """`demo --cpu --seconds 0.2` (and with --eq-preset): the port's JSON
    equals the JAX report on every key, output_peak within relative 1e-5,
    plus the port's "device"."""
    extra = ["--eq-preset", eq_preset] if eq_preset else []
    reports = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        rc, out = _cli(main, ["--data-dir", str(tmp_path / name), "demo",
                              "--cpu", "--seconds", "0.2", *extra], capsys)
        assert rc == 0
        reports[name] = json.loads(out.out)
    t, j = reports["torch"], reports["jax"]
    assert t.pop("device") == "cpu"
    assert set(t) == set(j)
    assert t["status"] == "processing" and t["spatial_ready"] is True
    assert t["output_peak"] > 0
    assert t["output_peak"] == pytest.approx(j["output_peak"], rel=1e-5)
    for key in t:
        if key != "output_peak":
            assert t[key] == j[key], key
    if eq_preset:
        assert t["equalizer_preset"] == "Bass Booster"


def test_demo_and_presets_default_to_the_card(tmp_path):
    """Without --cpu or --device both commands ask for the card; where
    there is none they raise before running anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run")
    for argv in (["demo", "--seconds", "0.1"], ["presets", "seed"]):
        with pytest.raises(RuntimeError, match="is_available"):
            torch_main(["--data-dir", str(tmp_path / "d"), *argv])


def test_demo_cpu_reaches_every_builder(tmp_path):
    """`--device cpu` reaches the spatial engine, the HRIR library and the
    renderer that a mid-stream HRIR swap's re-prepare builds."""
    from airwave_tpu_torch.shell.app import build_demo

    demo = build_demo(str(tmp_path / "d"), "cpu", "Vocal")
    demo.coordinator.launch()
    for _ in range(8):
        demo.transport.pump(512)
        demo.scheduler.advance(512 / RATE)
    assert demo.state.status.value == "processing"
    assert demo.hrir.device.type == "cpu"
    assert demo.spatial.engine.device.type == "cpu"
    room = next(p for p in demo.hrir.presets() if p.display_name == "Room")
    before = len(demo.trail)
    demo.profiles.set_hrir_preset_id(demo.output.uid, room.id)
    demo.transport.pump(512)
    renderer = demo.hrir.published_renderer
    assert demo.hrir.active_preset_id == room.id
    assert renderer.conv_params.Gflip2.device.type == "cpu"
    assert demo.spatial.engine.renderer is renderer
    assert demo.state.status.value == "processing"
    assert "starting" in demo.trail[before:]  # a pipeline restart
    assert demo.trail[-1] == "processing"
