"""shell/settings and assets/watcher of the port against the JAX package's.

The settings cases of tests/test_shell.py:28-70,340-377 and the watcher
case of tests/test_assets.py:436 run once on each package's own modules
(the JSON store, the settings, the presentation routing, the scheduler),
each in a directory of its own. Each run keeps the reference test's
assertions and returns a trace (migrated keys, onboarding steps, routes,
debounce fire times); the traces must be equal. Then a settings file
written by one package is read by the other."""

import importlib
import types

import pytest

_MODULES = {
    "store": "assets.store",
    "settings": "shell.settings",
    "pres": "shell.presentation",
    "scheduler": "runtime.scheduler",
    "watcher": "assets.watcher",
}


def _package(root: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        key: importlib.import_module(f"{root}.{name}")
        for key, name in _MODULES.items()})


PACKAGES = {"jax": _package("airwave_tpu"),
            "torch": _package("airwave_tpu_torch")}


def make_settings(P, path):
    return P.settings.KeyValueSettings(P.store.JSONStore(str(path)))


def run_both(tmp_path, scenario):
    """scenario(P, directory) on each package; returns the equal trace."""
    traces = {}
    for name, P in PACKAGES.items():
        directory = tmp_path / name
        directory.mkdir()
        traces[name] = scenario(P, directory)
    assert traces["jax"] == traces["torch"]
    return traces["torch"]


def schema_v2_migration(P, d):
    S = P.settings
    settings = make_settings(P, d / "settings.json")
    for key in S.LEGACY_KEYS:
        settings.set(key, "legacy")
    login = S.NoopLaunchAtLogin()
    trace = [S.migrate_schema_v2(settings, login), login.enabled]
    assert trace == [True, True]
    for key in S.LEGACY_KEYS:
        assert settings.get(key) is None
    assert settings.get(S.MARKER_KEY) is True
    login2 = S.NoopLaunchAtLogin()
    again = S.migrate_schema_v2(settings, login2)
    assert not again and not login2.enabled  # never re-runs
    return trace + [again, login2.enabled, S.MARKER_KEY, list(S.LEGACY_KEYS),
                    {k: settings.get(k) for k in S.LEGACY_KEYS + [S.MARKER_KEY]}]


def onboarding_version_reset_and_flow(P, d):
    S = P.settings
    settings = make_settings(P, d / "settings.json")
    settings.set("Airwave.OnboardingV2.Version", 1)
    settings.set("Airwave.OnboardingV2.Completed", True)
    settings.set(S.LEGACY_CAPTURE_FAILURE_KEY, "stale")
    persistence = S.OnboardingPersistence(settings)
    assert persistence.checkpoint == S.OnboardingStep.WELCOME
    assert not persistence.is_complete
    assert settings.get(S.LEGACY_CAPTURE_FAILURE_KEY) is None
    flow = S.OnboardingFlow(persistence)
    steps = [flow.advance(), flow.advance(), flow.back()]
    assert steps[0] == S.OnboardingStep.SYSTEM_AUDIO
    assert steps[1] == S.OnboardingStep.HRIR_PRESET
    assert steps[2] == S.OnboardingStep.SYSTEM_AUDIO
    flow.advance()
    flow.advance()
    assert flow.current == S.OnboardingStep.LIVE_HEALTH
    steps.append(flow.current)
    flow.advance()  # past the end completes
    assert persistence.is_complete
    assert S.OnboardingPersistence(settings).is_complete
    return [s.name for s in steps] + [persistence.is_complete]


def deferral_relaunch_and_version_bump(P, d):
    S, pres = P.settings, P.pres
    settings = make_settings(P, d / "settings.json")
    persistence = S.OnboardingPersistence(settings)
    flow = S.OnboardingFlow(persistence)
    flow.advance()
    flow.defer()
    assert persistence.is_deferred and not persistence.is_complete
    p2 = S.OnboardingPersistence(settings)
    assert p2.is_deferred
    assert p2.checkpoint == S.OnboardingStep.SYSTEM_AUDIO
    route2 = pres.route_launch(pres.LaunchReason.USER_OPEN, p2.is_complete,
                               p2.is_deferred)
    assert route2 == pres.LaunchRoute.SETTINGS
    settings.set("Airwave.OnboardingV2.Version", 999)
    p3 = S.OnboardingPersistence(settings)
    assert not p3.is_deferred and not p3.is_complete
    assert p3.checkpoint == S.OnboardingStep.WELCOME
    route3 = pres.route_launch(pres.LaunchReason.USER_OPEN, p3.is_complete,
                               p3.is_deferred)
    assert route3 == pres.LaunchRoute.SETUP
    return [p2.checkpoint.name, route2.name, p3.checkpoint.name, route3.name]


def completed_survives_relaunch_not_bump(P, d):
    S = P.settings
    settings = make_settings(P, d / "settings.json")
    persistence = S.OnboardingPersistence(settings)
    S.OnboardingFlow(persistence).complete()
    relaunched = S.OnboardingPersistence(settings).is_complete
    assert relaunched
    settings.set("Airwave.OnboardingV2.Version", 999)
    bumped = S.OnboardingPersistence(settings).is_complete
    assert not bumped
    return [relaunched, bumped]


@pytest.mark.parametrize("scenario", [
    schema_v2_migration, onboarding_version_reset_and_flow,
    deferral_relaunch_and_version_bump, completed_survives_relaunch_not_bump,
], ids=lambda f: f.__name__)
def test_settings_cases_match_jax(tmp_path, scenario):
    run_both(tmp_path, scenario)


def directory_watcher_debounces(P, d):
    sched = P.scheduler.ManualScheduler()
    fired = []
    watcher = P.watcher.DirectoryWatcher(
        str(d), lambda: fired.append(sched.now), sched, poll_interval=0.5,
        debounce=0.2)
    watcher.start()
    sched.advance(0.5)  # poll: no change
    assert fired == []
    (d / "new.txt").write_text("x")
    sched.advance(0.5)  # poll sees change -> debounce scheduled
    assert fired == []
    (d / "new2.txt").write_text("y")
    sched.advance(0.15)  # second poll restarts the debounce
    sched.advance(0.4)
    assert len(fired) == 1
    watcher.stop()
    (d / "new3.txt").write_text("z")
    sched.advance(2.0)
    assert len(fired) == 1
    return fired


def test_directory_watcher_fires_at_the_same_times(tmp_path):
    fired = run_both(tmp_path, directory_watcher_debounces)
    assert len(fired) == 1


def test_directory_fingerprint_matches_jax(tmp_path):
    (tmp_path / "a.wav").write_bytes(b"12345")
    (tmp_path / "sub").mkdir()
    prints = [P.watcher.directory_fingerprint(str(tmp_path))
              for P in PACKAGES.values()]
    assert prints[0] == prints[1] and len(prints[0]) == 2
    missing = str(tmp_path / "missing")
    assert (PACKAGES["jax"].watcher.directory_fingerprint(missing)
            == PACKAGES["torch"].watcher.directory_fingerprint(missing))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_settings_file_written_by_one_package_is_read_by_the_other(
        tmp_path, writer, reader):
    W, R = PACKAGES[writer], PACKAGES[reader]
    path = tmp_path / "settings.json"
    settings = make_settings(W, path)
    for key in W.settings.LEGACY_KEYS:
        settings.set(key, "legacy")
    assert W.settings.migrate_schema_v2(settings,
                                        W.settings.NoopLaunchAtLogin())
    flow = W.settings.OnboardingFlow(W.settings.OnboardingPersistence(settings))
    flow.advance()
    flow.advance()
    flow.defer()

    other = make_settings(R, path)
    login = R.settings.NoopLaunchAtLogin()
    assert not R.settings.migrate_schema_v2(other, login)  # already ran
    assert not login.enabled
    p = R.settings.OnboardingPersistence(other)
    assert p.is_deferred and not p.is_complete
    assert p.checkpoint == R.settings.OnboardingStep.HRIR_PRESET
    R.settings.OnboardingFlow(p).complete()
    assert W.settings.OnboardingPersistence(make_settings(W, path)).is_complete
