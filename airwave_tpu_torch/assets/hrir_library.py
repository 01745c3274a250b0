"""HRIR preset library + activation into published renderer states.

Port of airwave_tpu/assets/hrir_library.py, the same host code: the port
keeps its own copy and imports no module of the JAX package.

Re-implements Airwave/HRIRManager.swift:100-761 host-side:
  - presets dir with presets.json metadata (id, name, filename, channels,
    sample rate, frames)
  - import preflight (WAV must load; sane channel count) with filename
    collision handling (:204-280)
  - activation: load WAV -> channel map by channel count (7 -> hesuvi7, else
    hesuvi14, :355-360) -> resample to the output rate -> build the device
    conv params -> publish an immutable RendererState, generation-guarded
    (:480-501), deduped/cancelled by activation key via the coordinator
    (:52-81)
  - deactivation publishes None (render path falls back to passthrough)

The renderer is built on `device` (the card by default; nothing falls back
to the CPU). Each activation waits, on the thread that ran it (inline, or
the `run_async` worker), until the card has finished building the bank, so
the renderer it publishes is complete whichever stream the render thread
launches on.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
import uuid
from typing import Callable, Dict, List, Optional

import torch

from airwave_tpu_torch.assets import channel_maps as cm
from airwave_tpu_torch.assets.activation import PresetActivationCoordinator
from airwave_tpu_torch.assets.store import JSONStore
from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.graph.renderer import RendererState, prepare_renderer
from airwave_tpu_torch.io import wav
from airwave_tpu_torch.utils.errors import AirwaveError, WAVError

METADATA_NAME = "presets.json"


class HRIRImportError(AirwaveError):
    pass


@dataclasses.dataclass(frozen=True)
class HRIRPreset:
    id: str
    display_name: str
    filename: str
    channel_count: int
    sample_rate: float
    frame_count: int
    imported_at: float
    is_bundled: bool = False


@dataclasses.dataclass(frozen=True)
class ActivationKey:
    """Dedup key (ref HRIRManager.swift:52-64)."""

    preset_id: str
    filename: str
    output_sample_rate: float
    input_channels: int


class HRIRManager:
    def __init__(
        self,
        directory: str,
        block_size: int = 512,
        clock: Callable[[], float] = time.time,
        run_async: Optional[Callable] = None,
        device: "torch.device | str" = DEFAULT_DEVICE,
    ) -> None:
        self.directory = directory
        self.device = resolve_device(device)
        self.block_size = block_size
        self._clock = clock
        os.makedirs(directory, exist_ok=True)
        self._metadata = JSONStore(os.path.join(directory, METADATA_NAME))
        self._presets: Dict[str, HRIRPreset] = {}
        self._observers: List[Callable[[], None]] = []
        self._renderer_observers: List[Callable[[Optional[RendererState]], None]] = []
        self._coordinator = PresetActivationCoordinator(run_async)
        self._generation = 0
        self._latest_key: Optional[ActivationKey] = None
        self.published_renderer: Optional[RendererState] = None
        self.active_preset_id: Optional[str] = None
        self.reload()

    # --- observation ------------------------------------------------------------

    def observe(self, callback: Callable[[], None]) -> None:
        self._observers.append(callback)

    def observe_renderer(self, callback) -> None:
        self._renderer_observers.append(callback)

    def _notify(self) -> None:
        for observer in list(self._observers):
            observer()

    def _publish(self, renderer: Optional[RendererState]) -> None:
        self.published_renderer = renderer
        for observer in list(self._renderer_observers):
            observer(renderer)

    # --- library ------------------------------------------------------------------

    def presets(self) -> List[HRIRPreset]:
        return sorted(self._presets.values(), key=lambda p: p.display_name.lower())

    def preset(self, preset_id: str) -> Optional[HRIRPreset]:
        return self._presets.get(preset_id)

    def preset_ids(self) -> set:
        return set(self._presets)

    def reload(self) -> None:
        data = self._metadata.load() or {}
        presets: Dict[str, HRIRPreset] = {}
        for pid, meta in (data.get("presets") or {}).items():
            filename = meta.get("filename", "")
            # Traversal-resistant + corruption-tolerant row parsing (a bad
            # metadata row skips, it never crashes the library or escapes
            # the managed directory).
            if not filename or os.path.basename(filename) != filename:
                continue
            if not os.path.isfile(os.path.join(self.directory, filename)):
                continue
            try:
                presets[pid] = HRIRPreset(
                    id=pid,
                    display_name=str(meta.get("display_name", filename)),
                    filename=filename,
                    channel_count=int(meta.get("channel_count", 0)),
                    sample_rate=float(meta.get("sample_rate", 0.0)),
                    frame_count=int(meta.get("frame_count", 0)),
                    imported_at=float(meta.get("imported_at", 0.0)),
                    is_bundled=bool(meta.get("is_bundled", False)),
                )
            except (TypeError, ValueError):
                continue
        self._presets = presets
        self._notify()

    def _save_metadata(self) -> None:
        self._metadata.save({
            "presets": {
                p.id: {
                    "display_name": p.display_name,
                    "filename": p.filename,
                    "channel_count": p.channel_count,
                    "sample_rate": p.sample_rate,
                    "frame_count": p.frame_count,
                    "imported_at": p.imported_at,
                    "is_bundled": p.is_bundled,
                }
                for p in self._presets.values()
            }
        })

    def import_preset(self, source_path: str,
                      is_bundled: bool = False) -> HRIRPreset:
        """Preflight: the WAV must load and have a usable channel count."""
        if os.path.islink(source_path):
            raise HRIRImportError("symlinks are not importable")
        try:
            data = wav.load(source_path)
        except WAVError as err:
            raise HRIRImportError(f"not a loadable WAV: {err}")
        if data.channel_count < 2:
            raise HRIRImportError(
                f"HRIR needs >= 2 channels, got {data.channel_count}"
            )

        basename = os.path.basename(source_path)
        filename = self._unique_filename(basename)
        destination = os.path.join(self.directory, filename)
        staged = os.path.join(self.directory, f".import-{uuid.uuid4().hex}.tmp")
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

        preset = HRIRPreset(
            id=uuid.uuid4().hex,
            display_name=os.path.splitext(filename)[0],
            filename=filename,
            channel_count=data.channel_count,
            sample_rate=data.sample_rate,
            frame_count=data.frame_count,
            imported_at=self._clock(),
            is_bundled=is_bundled,
        )
        self._presets[preset.id] = preset
        try:
            self._save_metadata()
        except BaseException:
            self._presets.pop(preset.id, None)
            try:
                os.unlink(destination)
            except OSError:
                pass
            raise
        self._notify()
        return preset

    def delete_preset(self, preset_id: str) -> None:
        preset = self._presets.pop(preset_id, None)
        if preset is None:
            return
        try:
            self._save_metadata()
        except BaseException:
            self._presets[preset_id] = preset
            raise
        path = os.path.join(self.directory, preset.filename)
        if os.path.exists(path):
            os.unlink(path)
        if self.active_preset_id == preset_id:
            self.deactivate()
        self._notify()

    def _unique_filename(self, basename: str) -> str:
        stem, ext = os.path.splitext(basename)
        candidate = basename
        counter = 2
        # Like the EQ library's: a metadata row whose file vanished
        # externally must keep its filename reserved — rebinding it to a
        # fresh import would resurrect the old preset over the new file
        # (and make deleting one unlink the other).
        existing = {p.filename for p in self._presets.values()}
        while (
            candidate in existing
            or os.path.exists(os.path.join(self.directory, candidate))
        ):
            candidate = f"{stem} {counter}{ext}"
            counter += 1
        return candidate

    # --- activation -----------------------------------------------------------------

    def activate_preset(
        self,
        preset_id: str,
        output_sample_rate: float,
        input_layout: cm.InputLayout = cm.STEREO,
        completion: Optional[Callable[[Optional[Exception]], None]] = None,
    ) -> None:
        preset = self._presets.get(preset_id)
        if preset is None:
            if completion:
                completion(HRIRImportError(f"unknown preset {preset_id}"))
            return

        key = ActivationKey(preset_id, preset.filename, output_sample_rate,
                            len(input_layout.channels))
        self._generation += 1
        generation = self._generation
        # Staleness is judged per KEY, not per call: a duplicate request
        # coalesced by the coordinator must still complete its caller
        # (both resolved closures fire on the shared result), while an
        # activation superseded by a DIFFERENT preset/rate, or a
        # deactivation, drops silently (ref HRIRManager.swift:489).
        self._latest_key = key

        def work(key, token, done):
            try:
                data = wav.load(os.path.join(self.directory, preset.filename))
                channel_map = cm.select_channel_map(
                    data.channel_count, input_layout.channels
                )
                renderer = prepare_renderer(
                    data, input_layout, output_sample_rate,
                    self.block_size, channel_map, generation=generation,
                    device=self.device,
                )
                if self.device.type == "cuda":
                    # The bank's uploads and transforms are queued on this
                    # thread's stream: finish them before publishing.
                    torch.cuda.current_stream(self.device).synchronize()
            except Exception as err:  # noqa: BLE001
                done(("error", err))
                return
            if token.cancelled:
                done(("cancelled", None))
                return
            done(("ok", renderer))

        def resolved(result) -> None:
            status, value = result
            if self._latest_key != key:
                return  # superseded/deactivated: dropped (swift :489)
            if status == "ok":
                self.active_preset_id = preset_id
                self._publish(value)
                if completion:
                    completion(None)
            elif status == "error" and completion:
                completion(value)

        self._coordinator.request(key, work, resolved)

    def deactivate(self) -> None:
        self._generation += 1
        self._latest_key = None
        self.active_preset_id = None
        self._publish(None)

    # --- render-path view --------------------------------------------------------------

    def has_published_renderer(self) -> bool:
        return self.published_renderer is not None
