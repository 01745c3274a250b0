"""Equalizer preset library: managed directory + manifest, atomic imports.

Port of airwave_tpu/assets/eq_library.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.

Re-implements Airwave/EqualizerManager.swift:69-473:
  - managed presets dir with a manifest.json mapping preset id -> metadata
  - import validation: .txt extension, <= 1 MiB, not a symlink, parses as a
    valid EqualizerAPO configuration (:368-412)
  - atomic import: stage to temp, move in, save manifest; manifest-save
    failure rolls the file back out (:256-325)
  - deletion with restore-on-failure (:327-355)
  - reload() re-syncs from disk (the watcher's debounced target)
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
import uuid
from typing import Callable, Dict, List, Optional

from airwave_tpu_torch.io import apo
from airwave_tpu_torch.utils.errors import AirwaveError, EqualizerParseError

MANIFEST_NAME = "manifest.json"


class EqualizerImportError(AirwaveError):
    pass


@dataclasses.dataclass(frozen=True)
class EqualizerPreset:
    id: str
    display_name: str
    filename: str
    imported_at: float
    is_bundled: bool = False


class EqualizerManager:
    def __init__(self, directory: str,
                 clock: Callable[[], float] = time.time) -> None:
        self.directory = directory
        self._clock = clock
        os.makedirs(directory, exist_ok=True)
        from airwave_tpu_torch.assets.store import JSONStore

        self._manifest = JSONStore(os.path.join(directory, MANIFEST_NAME))
        self._presets: Dict[str, EqualizerPreset] = {}
        self._observers: List[Callable[[], None]] = []
        self.reload()

    # --- observation ---------------------------------------------------------

    def observe(self, callback: Callable[[], None]) -> None:
        self._observers.append(callback)

    def _notify(self) -> None:
        for observer in list(self._observers):
            observer()

    # --- reads -----------------------------------------------------------------

    def presets(self) -> List[EqualizerPreset]:
        return sorted(self._presets.values(), key=lambda p: p.display_name.lower())

    def preset(self, preset_id: str) -> Optional[EqualizerPreset]:
        return self._presets.get(preset_id)

    def preset_ids(self) -> set:
        return set(self._presets)

    def load_definition(self, preset_id: str) -> apo.EqualizerDefinition:
        preset = self._presets.get(preset_id)
        if preset is None:
            raise EqualizerImportError(f"unknown preset {preset_id}")
        path = os.path.join(self.directory, preset.filename)
        with open(path, "rb") as f:
            return apo.parse(f.read(), preset.filename)

    # --- manifest sync -----------------------------------------------------------

    def reload(self) -> None:
        """Resync manifest with the files actually on disk."""
        data = self._manifest.load() or {}
        presets: Dict[str, EqualizerPreset] = {}
        for pid, meta in (data.get("presets") or {}).items():
            filename = meta.get("filename", "")
            # Traversal-resistant (ref EqualizerLibraryTests): a corrupt or
            # hostile manifest row must not reach outside the managed dir.
            if not filename or os.path.basename(filename) != filename:
                continue
            if not os.path.isfile(os.path.join(self.directory, filename)):
                continue
            try:
                imported_at = float(meta.get("imported_at", 0.0))
            except (TypeError, ValueError):
                imported_at = 0.0
            presets[pid] = EqualizerPreset(
                id=pid,
                display_name=str(meta.get("display_name", filename)),
                filename=filename,
                imported_at=imported_at,
                is_bundled=bool(meta.get("is_bundled", False)),
            )
        self._presets = presets
        self._notify()

    def _save_manifest(self) -> None:
        self._manifest.save({
            "presets": {
                p.id: {
                    "display_name": p.display_name,
                    "filename": p.filename,
                    "imported_at": p.imported_at,
                    "is_bundled": p.is_bundled,
                }
                for p in self._presets.values()
            }
        })

    # --- import / delete ------------------------------------------------------------

    def validate_source(self, path: str) -> apo.EqualizerDefinition:
        """Preflight (swift :368-412): ext, size, symlink, parse."""
        if os.path.islink(path):
            raise EqualizerImportError("symlinks are not importable")
        if not path.lower().endswith(".txt"):
            raise EqualizerImportError("equalizer presets must be .txt files")
        try:
            size = os.path.getsize(path)
        except OSError as err:
            raise EqualizerImportError(f"unreadable file: {err}")
        if size > apo.MAX_DATA_SIZE:
            raise EqualizerImportError("file exceeds the 1 MiB limit")
        with open(path, "rb") as f:
            data = f.read()
        return apo.parse(data, os.path.basename(path))  # raises on invalid

    def import_preset(self, source_path: str,
                      is_bundled: bool = False) -> EqualizerPreset:
        self.validate_source(source_path)
        basename = os.path.basename(source_path)
        filename = self._unique_filename(basename)
        staged = os.path.join(self.directory, f".import-{uuid.uuid4().hex}.tmp")
        destination = os.path.join(self.directory, filename)
        try:
            shutil.copyfile(source_path, staged)
            os.replace(staged, destination)
        except BaseException:
            # Never leak a stage file into the watched managed directory.
            try:
                os.unlink(staged)
            except OSError:
                pass
            raise

        preset = EqualizerPreset(
            id=uuid.uuid4().hex,
            display_name=os.path.splitext(filename)[0],
            filename=filename,
            imported_at=self._clock(),
            is_bundled=is_bundled,
        )
        self._presets[preset.id] = preset
        try:
            self._save_manifest()
        except BaseException:
            # Roll the file back out so disk matches the manifest (swift :293-311).
            self._presets.pop(preset.id, None)
            try:
                os.unlink(destination)
            except OSError:
                pass
            raise
        self._notify()
        return preset

    def import_presets(self, paths: List[str]):
        """Returns (imported presets, {path: error})."""
        imported, failures = [], {}
        for path in paths:
            try:
                imported.append(self.import_preset(path))
            except (EqualizerImportError, EqualizerParseError, OSError) as err:
                failures[path] = err
        return imported, failures

    def delete_preset(self, preset_id: str) -> None:
        preset = self._presets.get(preset_id)
        if preset is None:
            return
        path = os.path.join(self.directory, preset.filename)
        backup = path + ".deleting"
        if os.path.exists(path):
            os.replace(path, backup)
        self._presets.pop(preset_id)
        try:
            self._save_manifest()
        except BaseException:
            # Restore on failure (swift :327-355).
            self._presets[preset_id] = preset
            if os.path.exists(backup):
                os.replace(backup, path)
            raise
        if os.path.exists(backup):
            os.unlink(backup)
        self._notify()

    def _unique_filename(self, basename: str) -> str:
        stem, ext = os.path.splitext(basename)
        candidate = basename
        counter = 2
        existing = {p.filename for p in self._presets.values()}
        while (
            candidate in existing
            or os.path.exists(os.path.join(self.directory, candidate))
        ):
            candidate = f"{stem} {counter}{ext}"
            counter += 1
        return candidate
