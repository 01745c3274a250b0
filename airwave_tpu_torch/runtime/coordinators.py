"""Coordinators wiring profiles + preset libraries into the runtime.

Port of airwave_tpu/runtime/coordinators.py, the same host code: the port
keeps its own copy and imports no module of the JAX package.

Re-implements:
  - DeviceProfileRuntimeCoordinator
    (Airwave/DeviceProfileRuntimeCoordinator.swift:37-171):
    resolves the current output's profile into effect readiness — deactivates
    stale HRIR state, sanitizes dangling preset IDs, defers preparation until
    the HRIR library's initial sync is ready, activates the HRIR preset at
    the output rate with the stereo input layout, and routes profile changes
    (EQ = live update fast path, HRIR = full reprepare) and library
    reconciliation.
  - OutputDeviceDiscoveryCoordinator
    (Airwave/OutputDeviceDiscoveryCoordinator.swift:23-42):
    pumps transport device inventory into the profile store.
"""

from __future__ import annotations

from typing import Callable, Optional

from airwave_tpu_torch.assets import channel_maps as cm
from airwave_tpu_torch.assets.profiles import DeviceProfileManager, ProfileChangeKind
from airwave_tpu_torch.runtime.transport import OutputDeviceDescriptor


class OutputDeviceDiscoveryCoordinator:
    def __init__(self, transport, profiles: DeviceProfileManager) -> None:
        self.transport = transport
        self.profiles = profiles

    def launch(self) -> None:
        self.profiles.update_available_devices(self.transport.list_output_devices())
        self.transport.observe_device_list(self.profiles.update_available_devices)


class DeviceProfileRuntimeCoordinator:
    def __init__(
        self,
        profiles: DeviceProfileManager,
        hrir_manager,
        equalizer_manager,
        controller,
        spatial_effect,
        input_layout=cm.STEREO,
    ) -> None:
        self.profiles = profiles
        self.hrir = hrir_manager
        self.equalizer = equalizer_manager
        self.controller = controller
        self.spatial = spatial_effect
        self.input_layout = input_layout
        self.current_output: Optional[OutputDeviceDescriptor] = None
        self._library_ready = True  # flips False until initial sync if deferred
        self._pending_preparation = None  # (output, completion)

    # --- lifecycle ---------------------------------------------------------------

    def launch(self) -> None:
        self.controller.set_profile_preparer(self)
        self.profiles.observe(self._profile_changed)
        self.hrir.observe(self._libraries_changed)
        self.equalizer.observe(self._libraries_changed)
        self.hrir.observe_renderer(self._renderer_published)
        self.controller.launch()

    def set_library_ready(self, ready: bool) -> None:
        """Initial-sync gate (ref pendingPreparation, swift :94-96)."""
        self._library_ready = ready
        if ready and self._pending_preparation is not None:
            output, completion = self._pending_preparation
            self._pending_preparation = None
            self.prepare(output, completion)

    # --- profile preparer (controller seam) ------------------------------------------

    def prepare(self, output: OutputDeviceDescriptor, completion: Callable) -> None:
        if not self._library_ready:
            self._pending_preparation = (output, completion)
            return
        self.current_output = output
        self._sanitize_dangling_ids()

        hrir_id = self.profiles.hrir_preset_id(output.uid)
        eq_definition = self._equalizer_definition_for(output.uid)

        def finish(_err=None) -> None:
            renderer = self.hrir.published_renderer
            self.spatial.set_renderer(renderer)
            readiness = self.controller.effect_graph.prepare(
                output.nominal_sample_rate, eq_definition
            )
            completion(readiness)

        if hrir_id is not None:
            self.hrir.activate_preset(
                hrir_id,
                output.nominal_sample_rate,
                self.input_layout,
                completion=finish,
            )
        else:
            self.hrir.deactivate()
            finish()

    def current_equalizer_definition(self):
        if self.current_output is None:
            return None
        return self._equalizer_definition_for(self.current_output.uid)

    def _equalizer_definition_for(self, device_uid: str):
        eq_id = self.profiles.equalizer_preset_id(device_uid)
        if eq_id is None:
            return None
        try:
            return self.equalizer.load_definition(eq_id)
        except Exception:  # noqa: BLE001 — dangling/invalid: treated as none
            return None

    # --- change routing ------------------------------------------------------------------

    def _profile_changed(self, change) -> None:
        if self.current_output is None:
            return
        if change.device_uid and change.device_uid != self.current_output.uid:
            return
        if change.kind == ProfileChangeKind.EQUALIZER:
            # Live retarget without pipeline restart (ref swift :134-140).
            self.controller.update_readiness("equalizerTarget")
        elif change.kind == ProfileChangeKind.HRIR:
            self.controller.reprepare_current_output()

    def _libraries_changed(self) -> None:
        """Preset-list changes: clear dangling assignments (ref :147-164)."""
        affected = self.profiles.clear_dangling_preset_ids(
            valid_hrir_ids=self.hrir.preset_ids(),
            valid_equalizer_ids=self.equalizer.preset_ids(),
        )
        if (
            self.current_output is not None
            and self.current_output.uid in affected
        ):
            self.controller.reprepare_current_output()

    def _renderer_published(self, renderer) -> None:
        self.spatial.set_renderer(renderer)

    def _sanitize_dangling_ids(self) -> None:
        self.profiles.clear_dangling_preset_ids(
            valid_hrir_ids=self.hrir.preset_ids(),
            valid_equalizer_ids=self.equalizer.preset_ids(),
        )
