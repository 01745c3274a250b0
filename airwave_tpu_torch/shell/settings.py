"""Settings persistence, schema-v2 migration, onboarding persistence.

Re-implements the persistence contracts of
Airwave/ProductSetup.swift:53-151:
  - SettingsSchemaV2 migration: one-shot marker, legacy keys cleared,
    launch-at-login enabled on first run (injectable seam)
  - Onboarding persistence v2: version mismatch resets checkpoint/completion/
    deferral; stale persisted capture-failure state is dropped (runtime
    failures are live state)

Port of airwave_tpu/shell/settings.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.
"""

from __future__ import annotations

import enum
from typing import List, Protocol

from airwave_tpu_torch.assets.store import JSONStore

MARKER_KEY = "Airwave.SchemaV2.ResetCompleted"
LEGACY_KEYS = [
    "Airwave.AppSettings",
    "Airwave.Onboarding.Version",
    "Airwave.Onboarding.Checkpoint",
    "Airwave.Onboarding.Completed",
    "Airwave.Onboarding.DismissedLaunch",
    "Airwave.Onboarding.CurrentLaunch",
    "SavedSystemOutputDeviceUID",
]
LEGACY_CAPTURE_FAILURE_KEY = "Airwave.OnboardingV2.CaptureFailure"

ONBOARDING_VERSION = 2
_VERSION_KEY = "Airwave.OnboardingV2.Version"
_CHECKPOINT_KEY = "Airwave.OnboardingV2.Checkpoint"
_COMPLETION_KEY = "Airwave.OnboardingV2.Completed"
_DEFERRED_KEY = "Airwave.OnboardingV2.Deferred"


_MISSING = object()


class KeyValueSettings:
    """JSON-file key-value store (UserDefaults analog)."""

    def __init__(self, store: JSONStore) -> None:
        self._store = store
        self._data = store.load() or {}

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def set(self, key: str, value) -> None:
        self._data[key] = value
        self._store.save(self._data)

    def remove(self, key: str) -> None:
        if key in self._data:
            del self._data[key]
            self._store.save(self._data)

    def update(self, values: dict, remove: tuple = ()) -> None:
        """Apply several changes in ONE atomic file write — multi-key
        transitions (migrations, version resets) must not be observable
        half-applied after a mid-sequence crash."""
        changed = False
        for key in remove:
            if key in self._data:
                del self._data[key]
                changed = True
        for key, value in values.items():
            if self._data.get(key, _MISSING) != value:
                self._data[key] = value
                changed = True
        if changed:
            self._store.save(self._data)

    def keys(self) -> List[str]:
        return list(self._data)


class LaunchAtLoginResetting(Protocol):
    def enable_for_first_run(self) -> None: ...


class NoopLaunchAtLogin:
    """Headless deployments have no login item; the seam stays for hosts
    that do (ref LaunchAtLoginManager.swift:19-62)."""

    def __init__(self) -> None:
        self.enabled = False

    def enable_for_first_run(self) -> None:
        self.enabled = True


def migrate_schema_v2(settings: KeyValueSettings,
                      launch_at_login: LaunchAtLoginResetting) -> bool:
    """One-shot v2 reset (ref ProductSetup.swift:53-76). Returns True when
    the migration ran."""
    if settings.get(MARKER_KEY, False):
        return False
    launch_at_login.enable_for_first_run()
    # One atomic write: legacy keys go and the marker lands together, so a
    # crash can never commit the marker with legacy state intact.
    settings.update({MARKER_KEY: True}, remove=tuple(LEGACY_KEYS))
    return True


class OnboardingStep(enum.Enum):
    WELCOME = "welcome"
    SYSTEM_AUDIO = "systemAudio"
    HRIR_PRESET = "hrirPreset"
    LIVE_HEALTH = "liveHealth"

    @property
    def title(self) -> str:
        return {
            OnboardingStep.WELCOME: "Welcome",
            OnboardingStep.SYSTEM_AUDIO: "System Audio Capture",
            OnboardingStep.HRIR_PRESET: "HRIR Preset",
            OnboardingStep.LIVE_HEALTH: "Finish",
        }[self]


ONBOARDING_STEPS = list(OnboardingStep)


class OnboardingPersistence:
    """Versioned onboarding state (ref ProductSetup.swift:110-151)."""

    def __init__(self, settings: KeyValueSettings) -> None:
        self._settings = settings
        # Runtime failures are live state; old builds persisted them.
        settings.remove(LEGACY_CAPTURE_FAILURE_KEY)
        if settings.get(_VERSION_KEY, 0) != ONBOARDING_VERSION:
            # One atomic write, reset state and version marker together —
            # the marker must never land without the reset (a crash
            # between them would leave stale prior-version completion
            # standing forever).
            settings.update({
                _VERSION_KEY: ONBOARDING_VERSION,
                _CHECKPOINT_KEY: OnboardingStep.WELCOME.value,
                _COMPLETION_KEY: False,
                _DEFERRED_KEY: False,
            })

    @property
    def checkpoint(self) -> OnboardingStep:
        raw = self._settings.get(_CHECKPOINT_KEY, "")
        try:
            return OnboardingStep(raw)
        except ValueError:
            return OnboardingStep.WELCOME

    @checkpoint.setter
    def checkpoint(self, step: OnboardingStep) -> None:
        self._settings.set(_CHECKPOINT_KEY, step.value)

    @property
    def is_complete(self) -> bool:
        return bool(self._settings.get(_COMPLETION_KEY, False))

    @is_complete.setter
    def is_complete(self, value: bool) -> None:
        self._settings.set(_COMPLETION_KEY, bool(value))

    @property
    def is_deferred(self) -> bool:
        return bool(self._settings.get(_DEFERRED_KEY, False))

    @is_deferred.setter
    def is_deferred(self, value: bool) -> None:
        self._settings.set(_DEFERRED_KEY, bool(value))


class OnboardingFlow:
    """Step machine over the persistence (advance/back/defer/complete)."""

    def __init__(self, persistence: OnboardingPersistence) -> None:
        self.persistence = persistence

    @property
    def current(self) -> OnboardingStep:
        return self.persistence.checkpoint

    def advance(self) -> OnboardingStep:
        steps = ONBOARDING_STEPS
        index = steps.index(self.current)
        if index + 1 < len(steps):
            self.persistence.checkpoint = steps[index + 1]
        else:
            self.persistence.is_complete = True
        return self.current

    def back(self) -> OnboardingStep:
        steps = ONBOARDING_STEPS
        index = steps.index(self.current)
        if index > 0:
            self.persistence.checkpoint = steps[index - 1]
        return self.current

    def defer(self) -> None:
        self.persistence.is_deferred = True

    def complete(self) -> None:
        self.persistence.is_complete = True
        self.persistence.checkpoint = OnboardingStep.LIVE_HEALTH
