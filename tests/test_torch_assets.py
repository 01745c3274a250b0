"""The port's asset libraries against the JAX package's: the JSON store,
device profiles, the EQ and HRIR preset libraries, latest-wins activation
and the bundled presets.

Each case of tests/test_assets.py (all but the directory watcher, held in
tests/test_torch_settings.py) runs twice, once on each package's own classes, in a
directory of its own, with the same injected clock and the same
deterministic preset ids (uuid.uuid4 patched the same way for both). Each
run keeps its assertions and returns a trace; the traces must be equal.
Then the data directories themselves: a directory seeded and edited by
one package is read by the other's managers, the bundled HRIR banks and
the seeded files are the same bytes, and a renderer activated by the
port's HRIRManager equals the JAX one (rel-RMS <= 1e-6 on the bank).
"""

import importlib
import json
import os
import threading
import types
import uuid

import numpy as np
import pytest
import torch

_MODULES = {
    "bundled": "assets.bundled",
    "activation": "assets.activation",
    "eq_library": "assets.eq_library",
    "hrir_library": "assets.hrir_library",
    "profiles": "assets.profiles",
    "store": "assets.store",
    "wav": "io.wav",
    "errors": "utils.errors",
    "transport": "runtime.transport",
    "convert": "tools.convert",
}

RENDERER_TOL = 1e-6  # rel-RMS, the activated bank against the JAX one


def _package(root: str) -> types.SimpleNamespace:
    P = types.SimpleNamespace(**{
        key: importlib.import_module(f"{root}.{name}")
        for key, name in _MODULES.items()})
    extra = {"device": "cpu"} if root == "airwave_tpu_torch" else {}

    def hrir_manager(directory, **kw):
        return P.hrir_library.HRIRManager(str(directory), **kw, **extra)

    P.hrir_manager = hrir_manager
    return P


PACKAGES = {"jax": _package("airwave_tpu"),
            "torch": _package("airwave_tpu_torch")}
JAX, TORCH = PACKAGES["jax"], PACKAGES["torch"]


def make_clock(start=1000.0):
    state = {"now": start}

    def clock():
        state["now"] += 1.0
        return state["now"]

    return clock


@pytest.fixture
def run_both(tmp_path, monkeypatch):
    """run_both(scenario): scenario(P, directory) on each package, with
    preset ids drawn from the same counter; the traces must agree."""
    counter = {"n": 0}

    def fake_uuid4():
        counter["n"] += 1
        return uuid.UUID(int=counter["n"])

    monkeypatch.setattr(uuid, "uuid4", fake_uuid4)

    def run(scenario):
        traces = {}
        for name, P in PACKAGES.items():
            counter["n"] = 0
            directory = tmp_path / name
            directory.mkdir()
            traces[name] = scenario(P, directory)
        assert traces["torch"] == traces["jax"]
        return traces["torch"]

    return run


def rel_rms(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


def bank(renderer) -> np.ndarray:
    g = renderer.conv_params.Gflip2
    return g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)


def digest(renderer):
    if renderer is None:
        return None
    return ([getattr(s, "name", str(s)) for s in renderer.speakers],
            renderer.sample_rate, renderer.block_size,
            renderer.partition_count, bank(renderer).shape)


def presets_of(manager):
    return [(p.id, p.display_name, p.filename, p.is_bundled,
             getattr(p, "sample_rate", None),
             getattr(p, "channel_count", None),
             getattr(p, "frame_count", None)) for p in manager.presets()]


# --- device profiles -------------------------------------------------------------


def profiles_persist_roundtrip_and_schema_versioning(P, d):
    store = P.store.JSONStore(str(d / "profiles.json"))
    m = P.profiles.DeviceProfileManager(store, clock=make_clock())
    m.set_hrir_preset_id("dev-1", "hrir-a")
    m.set_equalizer_preset_id("dev-1", "eq-b")
    m2 = P.profiles.DeviceProfileManager(store)
    assert m2.hrir_preset_id("dev-1") == "hrir-a"
    assert m2.equalizer_preset_id("dev-1") == "eq-b"
    on_disk = store.load()
    store.save({"schemaVersion": 99, "payload": [{"device_uid": "dev-9"}]})
    m3 = P.profiles.DeviceProfileManager(store)
    assert m3.profile("dev-9") is None
    return on_disk


def profiles_dedup_keeps_latest_last_seen(P, d):
    store = P.store.JSONStore(str(d / "profiles.json"))
    store.save({"schemaVersion": 1, "payload": [
        {"device_uid": "d", "hrir_preset_id": "old", "last_seen_at": 1.0},
        {"device_uid": "d", "hrir_preset_id": "new", "last_seen_at": 2.0},
    ]})
    m = P.profiles.DeviceProfileManager(store)
    assert m.hrir_preset_id("d") == "new"
    return m.profile("d").to_json()


def profiles_targets_merged_view_and_change_revisions(P, d):
    Out = P.transport.OutputDeviceDescriptor
    m = P.profiles.DeviceProfileManager(
        P.store.JSONStore(str(d / "profiles.json")), clock=make_clock())
    changes = []
    m.observe(changes.append)
    m.set_hrir_preset_id("remembered-dev", "h1")
    m.update_available_devices([Out(uid="live-dev", name="Speakers"),
                                Out(uid="virtual", name="X", is_virtual=True)])
    rows = m.targets()
    assert [(r.device_uid, r.is_available) for r in rows] == [
        ("live-dev", True), ("remembered-dev", False)]
    assert rows[0].profile is None and m.profile("live-dev") is None
    before = len(changes)
    m.set_hrir_preset_id("live-dev", None)
    assert m.profile("live-dev") is None and len(changes) == before
    m.set_hrir_preset_id("live-dev", "h2")
    assert m.profile("live-dev").name == "Speakers"
    m.forget_device("remembered-dev")
    assert m.profile("remembered-dev") is None
    m.reset_profile("live-dev")
    assert m.profile("live-dev").hrir_preset_id is None
    m.forget_device("live-dev")
    m.update_available_devices([Out(uid="live-dev", name="Speakers")])
    assert m.profile("live-dev") is None
    revisions = [c.revision for c in changes]
    assert revisions == sorted(revisions)
    assert len(set(revisions)) == len(revisions)
    return [(c.kind.value, c.device_uid, c.revision) for c in changes]


def profiles_persist_last_seen_refreshes_debounced(P, d):
    t = [1000.0]
    Manager = P.profiles.DeviceProfileManager
    store = P.store.JSONStore(str(d / "profiles.json"))
    m = Manager(store, clock=lambda: t[0])
    m.set_hrir_preset_id("dev", "h1")
    dev = P.transport.OutputDeviceDescriptor(uid="dev", name="Speakers")
    m.update_available_devices([dev])

    def on_disk():
        fresh = Manager(P.store.JSONStore(store.path), clock=lambda: t[0])
        return fresh.profile("dev").last_seen_at

    seen = [on_disk()]
    t[0] += 10.0
    m.update_available_devices([dev])
    assert m.profile("dev").last_seen_at == t[0]
    assert on_disk() == seen[0]
    changes = []
    m.observe(changes.append)
    t[0] += Manager.SEEN_PERSIST_INTERVAL
    m.update_available_devices([dev])
    assert on_disk() == t[0] and changes == []
    seen.append(on_disk())
    for _ in range(int(Manager.SEEN_PERSIST_INTERVAL / 5) + 2):
        t[0] += 5.0
        m.update_available_devices([dev])
        seen.append(on_disk())
    assert seen[-1] > seen[1], "frequent refreshes never reached disk"
    return seen


def profiles_clear_dangling(P, d):
    m = P.profiles.DeviceProfileManager(
        P.store.JSONStore(str(d / "p.json")), clock=make_clock())
    m.set_hrir_preset_id("d1", "gone")
    m.set_equalizer_preset_id("d1", "kept")
    affected = m.clear_dangling_preset_ids(valid_hrir_ids={"other"},
                                           valid_equalizer_ids={"kept"})
    assert affected == ["d1"]
    assert m.hrir_preset_id("d1") is None
    assert m.equalizer_preset_id("d1") == "kept"
    return affected, m.profile("d1").to_json()


def inventory_filters_duplicate_uids(P, d):
    Out = P.transport.OutputDeviceDescriptor
    m = P.profiles.DeviceProfileManager(
        P.store.JSONStore(str(d / "profiles.json")), clock=make_clock())
    m.update_available_devices([Out(uid="dup", name="First"),
                                Out(uid="dup", name="Second"),
                                Out(uid="other", name="Other")])
    rows = [(t.device_uid, t.name) for t in m.targets() if t.is_available]
    assert rows == [("dup", "First"), ("other", "Other")]
    return rows


# --- equalizer library -----------------------------------------------------------------


def write_preset(path, text="Preamp: -3 dB\nFilter 1: ON PK Fc 100 Hz Gain 2 dB "
                            "Q 1\n"):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def eq_import_list_load_delete(P, d):
    m = P.eq_library.EqualizerManager(str(d / "eq"), clock=make_clock())
    src = write_preset(d / "My Preset.txt")
    preset = m.import_preset(src)
    assert m.presets()[0].display_name == "My Preset"
    definition = m.load_definition(preset.id)
    assert definition.preamp_db == -3
    preset2 = m.import_preset(src)
    assert preset2.filename != preset.filename
    m.delete_preset(preset.id)
    assert m.preset(preset.id) is None
    assert not os.path.exists(os.path.join(m.directory, preset.filename))
    m2 = P.eq_library.EqualizerManager(m.directory)
    assert {p.id for p in m2.presets()} == {preset2.id}
    return presets_of(m2), definition.preamp_db, len(definition.filters)


def eq_import_validation(P, d):
    m = P.eq_library.EqualizerManager(str(d / "eq"))
    raised = []
    bad_ext = d / "p.cfg"
    bad_ext.write_text("Preamp: -1 dB\n")
    too_big = d / "big.txt"
    too_big.write_bytes(b"#" + b"x" * 1_100_000)
    good = write_preset(d / "good.txt")
    link = d / "link.txt"
    os.symlink(good, link)
    for path, error in ((bad_ext, P.eq_library.EqualizerImportError),
                        (too_big, P.eq_library.EqualizerImportError),
                        (write_preset(d / "bad.txt", "garbage directive\n"),
                         P.errors.EqualizerParseError),
                        (link, P.eq_library.EqualizerImportError)):
        with pytest.raises(error) as exc:
            m.import_preset(str(path))
        raised.append((type(exc.value).__name__, str(exc.value)))
    assert m.presets() == []
    return raised


def eq_import_rolls_back_on_manifest_failure(P, d):
    m = P.eq_library.EqualizerManager(str(d / "eq"), clock=make_clock())
    src = write_preset(d / "p.txt")

    def boom():
        raise OSError("disk full")

    m._save_manifest = boom
    with pytest.raises(OSError):
        m.import_preset(src)
    leftovers = [f for f in os.listdir(m.directory) if f.endswith(".txt")]
    assert leftovers == [] and m.presets() == []
    return sorted(os.listdir(m.directory))


def eq_delete_restores_on_manifest_failure(P, d):
    m = P.eq_library.EqualizerManager(str(d / "eq"), clock=make_clock())
    preset = m.import_preset(write_preset(d / "p.txt"))

    def boom():
        raise OSError("disk full")

    m._save_manifest = boom
    with pytest.raises(OSError):
        m.delete_preset(preset.id)
    assert m.preset(preset.id) is not None
    assert os.path.exists(os.path.join(m.directory, preset.filename))
    return presets_of(m)


def manifest_corruption_and_traversal_rows_are_skipped(P, d):
    m = P.eq_library.EqualizerManager(str(d / "eq"), clock=make_clock())
    good = m.import_preset(write_preset(d / "good.txt"))
    (d / "outside.txt").write_text("Preamp: -1 dB\n")
    manifest_path = os.path.join(m.directory, "manifest.json")
    with open(manifest_path) as fh:
        data = json.load(fh)
    data["presets"]["evil"] = {"display_name": "evil",
                               "filename": os.path.join("..", "outside.txt"),
                               "imported_at": 1.0}
    data["presets"]["garbage"] = {"display_name": "g",
                                  "filename": good.filename,
                                  "imported_at": "not-a-number"}
    data["presets"]["gone"] = {"display_name": "gone",
                               "filename": "missing.txt", "imported_at": 2.0}
    with open(manifest_path, "w") as fh:
        json.dump(data, fh)
    m.reload()
    ids = m.preset_ids()
    assert "evil" not in ids and "gone" not in ids
    assert good.id in ids and "garbage" in ids
    assert m.preset("garbage").imported_at == 0.0
    survivors = presets_of(m)
    with open(manifest_path, "w") as fh:
        fh.write("{ not json")
    m.reload()
    assert m.presets() == []
    return survivors


# --- activation coordinator -----------------------------------------------------------


def activation_latest_wins_and_stale_dropped(P, d):
    c = P.activation.PresetActivationCoordinator()
    resolved, pending = [], {}

    def slow_work(key, token, done):
        pending[key] = (token, done)

    c.request("a", slow_work, lambda r: resolved.append(("a", r)))
    c.request("b", slow_work, lambda r: resolved.append(("b", r)))
    assert pending["a"][0].cancelled  # newest wins
    pending["a"][1]("result-a")  # stale completion dropped
    assert resolved == []
    pending["b"][1]("result-b")
    assert resolved == [("b", "result-b")]
    return resolved


def activation_coalesces_duplicate_keys(P, d):
    c = P.activation.PresetActivationCoordinator()
    resolved, pending = [], {}

    def slow_work(key, token, done):
        pending[key] = done

    c.request("k", slow_work, lambda r: resolved.append(1))
    c.request("k", slow_work, lambda r: resolved.append(2))
    assert len(pending) == 1
    pending["k"]("r")
    assert resolved == [1, 2]
    return resolved


def activation_raising_work_does_not_wedge_the_key(P, d):
    c = P.activation.PresetActivationCoordinator()
    resolved, done_box = [], {}

    def broken_work(key, token, done):
        raise RuntimeError("exploded before done()")

    with pytest.raises(RuntimeError):
        c.request("k", broken_work, lambda r: resolved.append(("dead", r)))
    assert resolved == []

    def good_work(key, token, done):
        done_box["done"] = done

    c.request("k", good_work, lambda r: resolved.append(("ok", r)))
    done_box["done"]("r")
    assert resolved == [("ok", "r")]
    return resolved


# --- HRIR library -----------------------------------------------------------------------


def make_hrir_file(P, path, channels=14, frames=256, rate=48_000, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((channels, frames)) * 0.1).astype(np.float32)
    P.wav.save(str(path), audio, rate)
    return str(path)


def hrir_import_never_rebinds_a_vanished_presets_filename(P, d):
    m = P.hrir_manager(d / "hrir", clock=make_clock())
    a = m.import_preset(make_hrir_file(P, d / "Set.wav"))
    os.unlink(os.path.join(m.directory, a.filename))  # external deletion
    (d / "src").mkdir()
    b = m.import_preset(make_hrir_file(P, d / "src" / "Set.wav"))
    assert b.filename != a.filename
    m.delete_preset(a.id)  # must not unlink b's file
    assert os.path.exists(os.path.join(m.directory, b.filename))
    m.reload()
    assert {p.id for p in m.presets()} == {b.id}
    return presets_of(m)


def hrir_import_activate_publish_deactivate(P, d):
    m = P.hrir_manager(d / "hrir", clock=make_clock())
    preset = m.import_preset(make_hrir_file(P, d / "Set A.wav"))
    assert preset.channel_count == 14 and preset.frame_count == 256
    published, errors = [], []
    m.observe_renderer(published.append)
    m.activate_preset(preset.id, 48_000.0, completion=errors.append)
    assert errors == [None]
    assert m.published_renderer.num_speakers == 2
    assert m.active_preset_id == preset.id
    active = digest(m.published_renderer)
    m.deactivate()
    assert m.published_renderer is None and published[-1] is None
    return presets_of(m), active, [digest(r) for r in published]


def hrir_import_preflight(P, d):
    m = P.hrir_manager(d / "hrir")
    raised = []
    not_wav = d / "x.wav"
    not_wav.write_bytes(b"junk")
    mono = d / "mono.wav"
    P.wav.save(str(mono), np.ones((1, 64), np.float32), 48_000)
    for path in (not_wav, mono):
        with pytest.raises(P.hrir_library.HRIRImportError) as exc:
            m.import_preset(str(path))
        raised.append(str(exc.value))
    return raised


def hrir_delete_active_preset_deactivates(P, d):
    m = P.hrir_manager(d / "hrir", clock=make_clock())
    preset = m.import_preset(make_hrir_file(P, d / "a.wav"))
    m.activate_preset(preset.id, 48_000.0)
    assert m.published_renderer is not None
    m.delete_preset(preset.id)
    assert m.published_renderer is None and m.preset(preset.id) is None
    return presets_of(m)


def hrir_7_channel_uses_symmetric_map(P, d):
    m = P.hrir_manager(d / "hrir", clock=make_clock())
    preset = m.import_preset(make_hrir_file(P, d / "seven.wav", channels=7))
    m.activate_preset(preset.id, 48_000.0)
    assert m.published_renderer is not None  # hesuvi7 map resolved FL/FR
    return digest(m.published_renderer)


def hrir_coalesced_duplicate_activations_both_complete(P, d):
    deferred = []
    m = P.hrir_manager(d / "hrir", clock=make_clock(),
                       run_async=deferred.append)
    preset = m.import_preset(make_hrir_file(P, d / "Set.wav"))
    done = []
    m.activate_preset(preset.id, 48_000.0,
                      completion=lambda e: done.append(("first", e)))
    m.activate_preset(preset.id, 48_000.0,
                      completion=lambda e: done.append(("second", e)))
    assert len(deferred) == 1  # coalesced into one renderer build
    deferred[0]()
    assert done == [("first", None), ("second", None)]
    first = digest(m.published_renderer)
    done.clear()
    deferred.clear()
    m.activate_preset(preset.id, 48_000.0,
                      completion=lambda e: done.append(("old", e)))
    m.activate_preset(preset.id, 44_100.0,
                      completion=lambda e: done.append(("new", e)))
    for fn in deferred:
        fn()
    assert ("old", None) not in done and ("new", None) in done
    return first, done, digest(m.published_renderer)


# --- bundled seeding -----------------------------------------------------------------------


def bundled_seed_idempotent_and_deletions_stick(P, d):
    eq = P.eq_library.EqualizerManager(str(d / "eq"), clock=make_clock())
    hrir = P.hrir_manager(d / "hrir", clock=make_clock())
    staging = str(d / "staging")
    P.bundled.seed_bundled_presets(eq, hrir, staging)
    assert len(eq.presets()) == 5 and len(hrir.presets()) == 3
    assert all(p.is_bundled for p in eq.presets())
    seeded = presets_of(eq), presets_of(hrir)
    eq.delete_preset(eq.presets()[0].id)
    hrir.delete_preset(hrir.presets()[0].id)
    P.bundled.seed_bundled_presets(eq, hrir, staging)
    assert len(eq.presets()) == 4 and len(hrir.presets()) == 2
    return seeded, presets_of(eq), presets_of(hrir)


def synthetic_hrir_properties(P, d):
    b = P.bundled.synthesize_hrir("neutral", length=2048)
    assert b.shape == (14, 2048)
    assert abs(float(np.max(np.abs(b))) - 0.9) < 1e-3
    assert np.argmax(np.abs(b[0])) < np.argmax(np.abs(b[1]))
    assert np.max(np.abs(b[0])) > np.max(np.abs(b[1]))
    assert abs(int(np.argmax(np.abs(b[6]))) - int(np.argmax(np.abs(b[13])))) <= 1

    def peak_itd(direct, cross):
        xc = np.correlate(np.abs(direct), np.abs(cross), "full")
        return abs(int(np.argmax(xc)) - (len(direct) - 1))

    itds = [peak_itd(b[0], b[1]), peak_itd(b[2], b[3]), peak_itd(b[4], b[5])]
    assert itds[2] <= itds[1] and itds[0] < itds[1]
    tails = [float(np.sum(P.bundled.synthesize_hrir(s, length=2048)[:, 1024:]
                          ** 2)) for s in ("neutral", "room", "stage")]
    assert tails[0] < tails[1] < tails[2]
    return itds, tails


ASSET_CASES = [
    profiles_persist_roundtrip_and_schema_versioning,
    profiles_dedup_keeps_latest_last_seen,
    profiles_targets_merged_view_and_change_revisions,
    profiles_persist_last_seen_refreshes_debounced,
    profiles_clear_dangling,
    inventory_filters_duplicate_uids,
    eq_import_list_load_delete,
    eq_import_validation,
    eq_import_rolls_back_on_manifest_failure,
    eq_delete_restores_on_manifest_failure,
    manifest_corruption_and_traversal_rows_are_skipped,
    activation_latest_wins_and_stale_dropped,
    activation_coalesces_duplicate_keys,
    activation_raising_work_does_not_wedge_the_key,
    hrir_import_never_rebinds_a_vanished_presets_filename,
    hrir_import_activate_publish_deactivate,
    hrir_import_preflight,
    hrir_delete_active_preset_deactivates,
    hrir_7_channel_uses_symmetric_map,
    hrir_coalesced_duplicate_activations_both_complete,
    bundled_seed_idempotent_and_deletions_stick,
    synthetic_hrir_properties,
]


@pytest.mark.parametrize("scenario", ASSET_CASES,
                         ids=[s.__name__ for s in ASSET_CASES])
def test_assets_match_jax(scenario, run_both):
    run_both(scenario)


# --- bit-equal bundled content -------------------------------------------------------------


@pytest.mark.parametrize("style", ["neutral", "room", "stage"])
def test_synthesize_hrir_bit_equal(style):
    j, t = JAX.bundled.synthesize_hrir(style), TORCH.bundled.synthesize_hrir(
        style)
    assert t.dtype == j.dtype == np.float32 and t.shape == (14, 4096)
    assert np.array_equal(t, j)


def test_fractional_delay_kernel_bit_equal():
    for fraction in np.random.default_rng(0).uniform(0.0, 1.0, 8):
        for taps in (3, 17, TORCH.convert.FRACTIONAL_DELAY_TAPS):
            assert np.array_equal(
                TORCH.convert.fractional_delay_kernel(fraction, taps),
                JAX.convert.fractional_delay_kernel(fraction, taps))
    assert TORCH.convert.FRACTIONAL_DELAY_TAPS == JAX.convert.FRACTIONAL_DELAY_TAPS
    with pytest.raises(ValueError):
        TORCH.convert.fractional_delay_kernel(0.5, 4)


def _seed(P, base):
    eq = P.eq_library.EqualizerManager(str(base / "eq"), clock=make_clock())
    hrir = P.hrir_manager(base / "hrir", clock=make_clock())
    P.bundled.seed_bundled_presets(eq, hrir, str(base / "staging"))
    return eq, hrir


def test_seeded_files_byte_equal(tmp_path, monkeypatch):
    """Both packages seed the same WAV and EQ files, byte for byte, and the
    same acknowledged-filenames markers."""
    trees = {}
    for name, P in PACKAGES.items():
        counter = iter(range(1, 1000))
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(counter)))
        _seed(P, tmp_path / name)
        root = tmp_path / name
        trees[name] = {
            str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
        }
    assert sorted(trees["torch"]) == sorted(trees["jax"])
    assert len([k for k in trees["torch"] if k.endswith(".wav")]) == 6
    for key, blob in trees["jax"].items():
        assert trees["torch"][key] == blob, key


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_data_directory_swaps_between_packages(tmp_path, writer, reader):
    """A directory seeded and edited by one package (an import, a deletion,
    profile bindings) is read by the other's managers with the same preset
    ids, names, sample rates and bindings."""
    W, R = PACKAGES[writer], PACKAGES[reader]
    eq, hrir = _seed(W, tmp_path)
    user = hrir.import_preset(make_hrir_file(W, tmp_path / "User 44k.wav",
                                             rate=44_100, frames=441))
    eq_user = eq.import_preset(write_preset(tmp_path / "Mine.txt"))
    eq.delete_preset(next(p.id for p in eq.presets()
                          if p.display_name == "Treble Reducer"))
    profiles = W.profiles.DeviceProfileManager(
        W.store.JSONStore(str(tmp_path / "profiles.json")), clock=make_clock())
    profiles.set_hrir_preset_id("dev-1", user.id)
    profiles.set_equalizer_preset_id("dev-1", eq_user.id)
    profiles.set_hrir_preset_id("dev-2", hrir.presets()[0].id)

    eq2 = R.eq_library.EqualizerManager(str(tmp_path / "eq"))
    hrir2 = R.hrir_manager(tmp_path / "hrir")
    profiles2 = R.profiles.DeviceProfileManager(
        R.store.JSONStore(str(tmp_path / "profiles.json")))
    assert presets_of(eq2) == presets_of(eq)
    assert presets_of(hrir2) == presets_of(hrir)
    assert hrir2.preset(user.id).sample_rate == 44_100.0
    for uid in ("dev-1", "dev-2"):
        assert profiles2.profile(uid).to_json() == profiles.profile(uid).to_json()
    assert (eq2.load_definition(eq_user.id).filters
            and len(eq2.load_definition(eq_user.id).filters)
            == len(eq.load_definition(eq_user.id).filters))
    # Reseeding from the other side keeps the deletion and adds nothing.
    R.bundled.seed_bundled_presets(eq2, hrir2, str(tmp_path / "staging"))
    assert presets_of(eq2) == presets_of(eq)
    assert presets_of(hrir2) == presets_of(hrir)


@pytest.mark.parametrize("rate", [48_000, 44_100])
def test_activated_renderer_matches_jax(tmp_path, rate):
    """The port's HRIRManager activates the renderer the JAX one does from
    the same directory: the bundled Neutral bank at 48 kHz, and a 44.1 kHz
    preset resampled to the 48 kHz output."""
    eq, hrir = _seed(JAX, tmp_path)
    if rate == 48_000:
        preset = next(p for p in hrir.presets() if p.display_name == "Neutral")
    else:
        preset = hrir.import_preset(make_hrir_file(
            JAX, tmp_path / "set441.wav", frames=441, rate=rate, seed=3))
    renderers = {}
    for name, P in PACKAGES.items():
        manager = P.hrir_manager(tmp_path / "hrir")
        errors = []
        manager.activate_preset(preset.id, 48_000.0, completion=errors.append)
        assert errors == [None]
        renderers[name] = manager.published_renderer
    t, j = renderers["torch"], renderers["jax"]
    assert t.conv_params.Gflip2.device.type == "cpu"
    assert digest(t) == digest(j)
    assert t.sample_rate == 48_000.0
    for field in ("Gflip2", "wf", "wi"):
        got = getattr(t.conv_params, field).numpy()
        assert rel_rms(got, np.asarray(getattr(j.conv_params, field))) \
            <= RENDERER_TOL, field


def test_activation_on_a_worker_thread(tmp_path):
    """run_async on a real worker thread: the renderer is built and
    published off the calling thread, complete, and equal to the inline
    activation's."""
    eq, hrir = _seed(TORCH, tmp_path)
    threads = []

    def run_async(fn):
        thread = threading.Thread(target=fn)
        threads.append(thread)
        thread.start()

    worker = TORCH.hrir_manager(tmp_path / "hrir", run_async=run_async)
    published, done = [], threading.Event()
    worker.observe_renderer(
        lambda r: published.append((r, threading.get_ident())))
    preset = hrir.presets()[0]
    worker.activate_preset(preset.id, 48_000.0,
                           completion=lambda e: done.set())
    assert done.wait(60.0)
    for thread in threads:
        thread.join(60.0)
    assert len(threads) == 1 and len(published) == 1
    renderer, ident = published[0]
    assert ident != threading.get_ident()
    inline = TORCH.hrir_manager(tmp_path / "hrir")
    inline.activate_preset(preset.id, 48_000.0)
    assert digest(renderer) == digest(inline.published_renderer)
    assert torch.equal(renderer.conv_params.Gflip2,
                       inline.published_renderer.conv_params.Gflip2)


def test_hrir_manager_defaults_to_the_card(tmp_path):
    """Without `device` the HRIR library builds its renderers on the card;
    where there is none it raises and builds nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run")
    with pytest.raises(RuntimeError, match="is_available"):
        TORCH.hrir_library.HRIRManager(str(tmp_path / "hrir"))
