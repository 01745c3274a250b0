"""Per-output-device effect profiles with persistence and change routing.

Port of airwave_tpu/assets/profiles.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.

Re-implements Airwave/DeviceProfileManager.swift:14-359:
  - profile store {device UID -> (hrir_preset_id?, equalizer_preset_id?,
    name, transport, last_seen_at)} persisted under a schema-versioned
    envelope (v1)
  - duplicate records deduped keeping the latest last_seen_at (:336-340)
  - merged "targets" view of currently-available + remembered devices (:68-97)
  - reset / forget, batch-clear of dangling preset IDs (:188-229)
  - a change channel with a monotonic revision and typed change kind
    (.hrir / .equalizer / metadata) driving the runtime coordinator (:52-53)
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional

from airwave_tpu_torch.assets.store import JSONStore, load_versioned, save_versioned
from airwave_tpu_torch.runtime.transport import OutputDeviceDescriptor

SCHEMA_VERSION = 1


class ProfileChangeKind(enum.Enum):
    HRIR = "hrir"
    EQUALIZER = "equalizer"
    METADATA = "metadata"


@dataclasses.dataclass(frozen=True)
class ProfileChange:
    kind: ProfileChangeKind
    device_uid: str
    revision: int


@dataclasses.dataclass
class DeviceProfile:
    device_uid: str
    name: str = ""
    transport_type: str = ""
    hrir_preset_id: Optional[str] = None
    equalizer_preset_id: Optional[str] = None
    last_seen_at: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(data: dict) -> Optional["DeviceProfile"]:
        try:
            uid = data["device_uid"]
        except (KeyError, TypeError):
            return None
        if not isinstance(uid, str) or not uid:
            return None
        try:
            last_seen = float(data.get("last_seen_at", 0.0))
        except (TypeError, ValueError):
            # Corrupt timestamps make the record unusable, not the store:
            # skip it like any other malformed entry.
            return None
        return DeviceProfile(
            device_uid=uid,
            name=str(data.get("name", "")),
            transport_type=str(data.get("transport_type", "")),
            hrir_preset_id=data.get("hrir_preset_id"),
            equalizer_preset_id=data.get("equalizer_preset_id"),
            last_seen_at=last_seen,
        )


@dataclasses.dataclass(frozen=True)
class ProfileTarget:
    """Merged view row: a device that is available now and/or remembered."""

    device_uid: str
    name: str
    is_available: bool
    profile: Optional[DeviceProfile]


class DeviceProfileManager:
    # Pure last_seen_at refreshes are persisted at most this often per
    # profile (metadata/effect changes always save immediately).
    SEEN_PERSIST_INTERVAL = 60.0

    def __init__(self, store: JSONStore, clock: Callable[[], float] = time.time):
        self._store = store
        self._clock = clock
        self._profiles: Dict[str, DeviceProfile] = {}
        # Per-UID timestamp of the last last_seen_at value that reached
        # disk (the SEEN_PERSIST_INTERVAL debounce keys on this).
        self._seen_persisted: Dict[str, float] = {}
        self._available: List[OutputDeviceDescriptor] = []
        self._revision = 0
        self._observers: List[Callable[[ProfileChange], None]] = []
        self._load()

    # --- persistence -----------------------------------------------------------

    def _load(self) -> None:
        payload = load_versioned(self._store, SCHEMA_VERSION)
        if not isinstance(payload, list):
            return
        for item in payload:
            profile = DeviceProfile.from_json(item)
            if profile is None:
                continue
            existing = self._profiles.get(profile.device_uid)
            # Dedup keeping the latest last_seen_at (swift :336-340).
            if existing is None or profile.last_seen_at >= existing.last_seen_at:
                self._profiles[profile.device_uid] = profile

    def _save(self) -> None:
        save_versioned(
            self._store,
            SCHEMA_VERSION,
            [p.to_json() for p in self._profiles.values()],
        )
        # Every save persists the current last_seen_at values wholesale;
        # record that so the refresh debounce measures from disk reality.
        self._seen_persisted = {
            uid: p.last_seen_at for uid, p in self._profiles.items()
        }

    # --- change channel -----------------------------------------------------------

    def observe(self, callback: Callable[[ProfileChange], None]) -> None:
        self._observers.append(callback)

    def _emit(self, kind: ProfileChangeKind, uid: str) -> None:
        self._revision += 1
        change = ProfileChange(kind, uid, self._revision)
        for observer in list(self._observers):
            observer(change)

    @property
    def revision(self) -> int:
        return self._revision

    # --- device inventory ------------------------------------------------------------

    def update_available_devices(
        self, devices: List[OutputDeviceDescriptor]
    ) -> None:
        """Record the current inventory. Observation NEVER materializes a
        profile (ref DeviceProfileManagerTests: an available-but-unsaved
        target stays selectable without persistence, and a forgotten
        device re-observed stays transient) — profiles come into being on
        the first effect selection. Remembered devices that reappear get
        their metadata refreshed. Unsupported and duplicate-UID entries
        are filtered at this boundary (ref
        OutputDeviceDiscoveryCoordinatorTests)."""
        seen: set = set()
        self._available = []
        for device in devices:
            if not device.is_supported_profile_output or device.uid in seen:
                continue
            seen.add(device.uid)
            self._available.append(device)
        now = self._clock()
        changed = False
        needs_save = False
        for device in self._available:
            profile = self._profiles.get(device.uid)
            if profile is None:
                continue  # unsaved target: transient, zero writes
            if profile.name != device.name or (
                profile.transport_type != device.transport_type
            ):
                changed = True
            # Pure last_seen_at refreshes persist too (debounced): the
            # load-time duplicate dedup keys on the PERSISTED timestamp,
            # so letting it go stale until an unrelated write could keep
            # the wrong record of a duplicated UID. The debounce compares
            # against the last PERSISTED value (not the in-memory one,
            # which this loop refreshes every call — comparing against it
            # would never persist under frequent device polls).
            persisted = self._seen_persisted.get(profile.device_uid, 0.0)
            if now - persisted >= self.SEEN_PERSIST_INTERVAL:
                needs_save = True
            profile.name = device.name
            profile.transport_type = device.transport_type
            profile.last_seen_at = now
        if changed or needs_save:
            self._save()  # also refreshes the _seen_persisted record
        if changed:
            self._emit(ProfileChangeKind.METADATA, "")

    # --- reads -----------------------------------------------------------------------

    def profile(self, device_uid: str) -> Optional[DeviceProfile]:
        return self._profiles.get(device_uid)

    def hrir_preset_id(self, device_uid: str) -> Optional[str]:
        profile = self._profiles.get(device_uid)
        return profile.hrir_preset_id if profile else None

    def equalizer_preset_id(self, device_uid: str) -> Optional[str]:
        profile = self._profiles.get(device_uid)
        return profile.equalizer_preset_id if profile else None

    def targets(self) -> List[ProfileTarget]:
        """Available devices first, then remembered-only, by name (swift :68-97)."""
        available_uids = {d.uid for d in self._available}
        rows: List[ProfileTarget] = []
        for device in self._available:
            rows.append(ProfileTarget(device.uid, device.name, True,
                                      self._profiles.get(device.uid)))
        remembered = [
            p for uid, p in self._profiles.items() if uid not in available_uids
        ]
        for profile in sorted(remembered, key=lambda p: (p.name, p.device_uid)):
            rows.append(ProfileTarget(profile.device_uid, profile.name, False,
                                      profile))
        return rows

    # --- writes ------------------------------------------------------------------------

    def _ensure(self, device_uid: str) -> DeviceProfile:
        profile = self._profiles.get(device_uid)
        if profile is None:
            profile = DeviceProfile(device_uid=device_uid,
                                    last_seen_at=self._clock())
            self._profiles[device_uid] = profile
        return profile

    def set_hrir_preset_id(self, device_uid: str, preset_id: Optional[str]) -> None:
        if preset_id is None and device_uid not in self._profiles:
            return  # nil selection for an unsaved target: zero-write no-op
        profile = self._ensure(device_uid)
        self._refresh_from_inventory(profile)
        profile.hrir_preset_id = preset_id
        self._save()
        self._emit(ProfileChangeKind.HRIR, device_uid)

    def set_equalizer_preset_id(
        self, device_uid: str, preset_id: Optional[str]
    ) -> None:
        if preset_id is None and device_uid not in self._profiles:
            return  # nil selection for an unsaved target: zero-write no-op
        profile = self._ensure(device_uid)
        self._refresh_from_inventory(profile)
        profile.equalizer_preset_id = preset_id
        self._save()
        self._emit(ProfileChangeKind.EQUALIZER, device_uid)

    def _refresh_from_inventory(self, profile: DeviceProfile) -> None:
        """A profile materializing (or being written) while its device is
        available picks up the live metadata."""
        for device in self._available:
            if device.uid == profile.device_uid:
                profile.name = device.name
                profile.transport_type = device.transport_type
                profile.last_seen_at = self._clock()
                return

    def reset_profile(self, device_uid: str) -> None:
        """Clear effect assignments but keep the remembered device."""
        profile = self._profiles.get(device_uid)
        if profile is None:
            return
        profile.hrir_preset_id = None
        profile.equalizer_preset_id = None
        self._save()
        self._emit(ProfileChangeKind.METADATA, device_uid)

    def forget_device(self, device_uid: str) -> None:
        if self._profiles.pop(device_uid, None) is not None:
            self._save()
            self._emit(ProfileChangeKind.METADATA, device_uid)

    def clear_dangling_preset_ids(
        self,
        valid_hrir_ids: Optional[set] = None,
        valid_equalizer_ids: Optional[set] = None,
    ) -> List[str]:
        """Batch-clear assignments whose presets no longer exist (swift :215-229).
        Returns affected device UIDs."""
        affected: List[str] = []
        for uid, profile in self._profiles.items():
            touched = False
            if (
                valid_hrir_ids is not None
                and profile.hrir_preset_id is not None
                and profile.hrir_preset_id not in valid_hrir_ids
            ):
                profile.hrir_preset_id = None
                touched = True
            if (
                valid_equalizer_ids is not None
                and profile.equalizer_preset_id is not None
                and profile.equalizer_preset_id not in valid_equalizer_ids
            ):
                profile.equalizer_preset_id = None
                touched = True
            if touched:
                affected.append(uid)
        if affected:
            self._save()
            self._emit(ProfileChangeKind.METADATA, "")
        return affected
