"""Effect-graph composition: spatial -> EQ ordering, warnings, passthrough.

Port of airwave_tpu/graph/effect_graph.py, which re-implements the
composition semantics of the reference's AudioEffectGraph.swift:65-248 and
its control-thread adapter EqualizerRuntimeEffect.swift:10-107:

  - fixed order: spatial THEN equalizer
  - EQ preparation failures are NON-FATAL warnings (line-numbered); spatial
    continues (:103-137)
  - update_equalizer keeps the EQ in the callback path so the unity ramp can
    play out after removal (:147-151)
  - passthrough copy when nothing runs; mono input duplicated to right
    (:223-245), both with zero added latency (only the spatial path carries
    the block-adapter latency).

The EQ of a batch of one runs on the host in float64 (EqualizerEffect); a
larger batch runs one eq_block.eq_step per callback on the device
(DeviceEqualizerEffect), a plain call where the JAX package jits it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Set

import numpy as np
import torch

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.graph.eq_processor import ParametricEqualizerProcessor
from airwave_tpu_torch.graph.eq_runtime import EqualizerRuntime
from airwave_tpu_torch.io.apo import EqualizerDefinition
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import eq_block
from airwave_tpu_torch.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu_torch.utils import errors

SPATIAL = "spatial"
EQUALIZER = "equalizer"


@dataclasses.dataclass(frozen=True)
class AudioEffectWarning:
    filter_line: Optional[int]
    reason: str

    def __str__(self) -> str:
        if self.filter_line is not None:
            return f"Equalizer line {self.filter_line}: {self.reason}"
        return f"Equalizer configuration: {self.reason}"


@dataclasses.dataclass(frozen=True)
class AudioEffectPreparationResult:
    runnable_effects: frozenset
    equalizer_warning: Optional[AudioEffectWarning] = None

    @property
    def no_effect_can_run(self) -> bool:
        return len(self.runnable_effects) == 0


def _warning_from_error(
    definition: Optional[EqualizerDefinition], err: Exception
) -> AudioEffectWarning:
    """Map preparation errors to line-numbered warnings
    (ref EqualizerRuntimeEffect.swift:80-100)."""
    if isinstance(err, errors.EqInvalidFilter) and definition is not None:
        enabled = definition.enabled_filters
        line = (
            enabled[err.index].source_line if err.index < len(enabled) else None
        )
        return AudioEffectWarning(line, str(err.error))
    if isinstance(err, errors.EqInvalidSampleRate):
        return AudioEffectWarning(None, "Output sample rate is invalid.")
    return AudioEffectWarning(None, str(err))


class EqualizerEffect:
    """Per-stream host EQ processors (ref EqualizerRuntimeEffect), float64.

    One independent processor per stream row: filter histories and
    crossfade progress are per-stream state. Target publication fans out
    to every row."""

    def __init__(self, config: AirwaveConfig = DEFAULT_CONFIG,
                 batch: int = 1) -> None:
        self.config = config
        self.batch = batch
        self.processors: list = []
        self._sample_rate: Optional[float] = None

    @property
    def processor(self) -> Optional[ParametricEqualizerProcessor]:
        """First row's processor (single-stream convenience)."""
        return self.processors[0] if self.processors else None

    def _publish_all(self, definition: Optional[EqualizerDefinition]) -> None:
        """Design the cascade ONCE, then give every stream row its own
        oracle over the shared coefficients."""
        preamp, coeffs = bd.design_cascade(definition, self._sample_rate)
        for processor in self.processors:
            # Control-thread housekeeping at publication time: free the
            # retirement slot so a queued ramp can start when the one in
            # flight finishes.
            processor.drain_retired_states()
            processor.publish(
                EqCascadeOracle(coeffs, preamp, self._sample_rate)
            )

    def prepare(
        self, definition: Optional[EqualizerDefinition], sample_rate: float
    ) -> None:
        # Reuse processors when the sample rate matches (swift :16-24).
        if not self.processors or self._sample_rate != sample_rate:
            self._sample_rate = sample_rate
            self.processors = [
                ParametricEqualizerProcessor(
                    sample_rate,
                    self.config.max_frames_per_callback,
                    self.config,
                )
                for _ in range(self.batch)
            ]
        self._publish_all(definition)

    def set_target(self, definition: Optional[EqualizerDefinition]) -> None:
        if not self.processors:
            raise errors.EqualizerPreparationError("equalizer not prepared")
        try:
            self._publish_all(definition)
        except errors.EqualizerPreparationError:
            # Invalid live preset: fall back to a unity target (swift :29-33).
            self._publish_all(None)
            raise

    def process(self, left: np.ndarray, right: Optional[np.ndarray],
                stream: int = 0):
        if not self.processors:
            raise RuntimeError("equalizer not prepared")
        if stream >= len(self.processors):
            raise ValueError(
                f"stream {stream} >= prepared batch {len(self.processors)}; "
                "construct EqualizerEffect(batch=...) to match the graph batch")
        return self.processors[stream].process(left, right)


class DeviceEqualizerEffect:
    """Batched live EQ: ONE eq_block.eq_step per callback on `device`.

    The whole [B, 2, n] block goes through the device EQ step (the one the
    StreamPool runs) under the EqualizerRuntime publication/crossfade
    protocol. Targets are observed at callback starts, the reference's
    render-thread observation points (ParametricEqualizerProcessor.swift:
    263-265); ramp values are per-sample exact. The cascade is designed
    once per target; the block-size-specific EqParams are built lazily per
    (target, n) and cached.
    """

    def __init__(self, config: AirwaveConfig = DEFAULT_CONFIG,
                 batch: int = 1,
                 device: "torch.device | str" = DEFAULT_DEVICE) -> None:
        self.config = config
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.runtime: Optional[EqualizerRuntime] = None
        self._state: Optional[eq_block.EqState] = None  # [B, 2, D]
        self._params_cache: dict = {}

    def prepare(
        self, definition: Optional[EqualizerDefinition], sample_rate: float
    ) -> None:
        if self.runtime is None or self.runtime.sample_rate != sample_rate:
            self.runtime = EqualizerRuntime(
                sample_rate, self.config.block_size,
                self.config.eq_state_dim, self.config, device=self.device,
            )
            self._state = eq_block.make_eq_state(
                self.batch, 2, self.config.eq_state_dim, self.device
            )
            self._params_cache.clear()
        self.runtime.set_target(definition)

    def set_target(self, definition: Optional[EqualizerDefinition]) -> None:
        if self.runtime is None:
            raise errors.EqualizerPreparationError("equalizer not prepared")
        self.runtime.drain_retired_states()  # control-thread housekeeping
        try:
            self.runtime.set_target(definition)
        except errors.EqualizerPreparationError:
            self.runtime.set_target(None)  # unity fallback (swift :29-33)
            raise

    def _params_for(self, prepared, n: int) -> eq_block.EqParams:
        key = (id(prepared), n)
        hit = self._params_cache.get(key)
        if hit is not None and hit[0] is prepared:
            return hit[1]
        if n == self.runtime.block_size:
            params = prepared.params
        else:
            preamp, coeffs = prepared.design
            params = eq_block.make_eq_params(
                coeffs, preamp, n, self.config.eq_state_dim,
                device=self.device,
            )
        self._params_cache[key] = (prepared, params)
        if len(self._params_cache) > 64:
            self._params_cache.pop(next(iter(self._params_cache)))
        return params

    @torch.inference_mode()
    def process_batch(self, y: np.ndarray) -> np.ndarray:
        """y [B, 2, n] -> [B, 2, n] in one device step."""
        runtime = self.runtime
        if runtime is None:
            raise RuntimeError("equalizer not prepared")
        B, _C, n = y.shape
        if B != self.batch:
            raise ValueError(f"batch {B}, effect prepared for {self.batch}")
        eq_state, _pf, _pt, _ = runtime.begin_block(self._state)
        p_from = self._params_for(
            runtime.transition_from
            if runtime.transition_from is not None else runtime.active, n
        )
        p_to = self._params_for(runtime.active, n)
        crossfading = (
            runtime.is_transitioning or runtime.pending_target is not None
        )
        x = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(
            self.device)
        eq_state, out = eq_block.eq_step(p_from, p_to, eq_state, x,
                                         runtime.transition_length,
                                         crossfading)
        self._state = eq_state
        runtime.after_block(n)
        return out.to("cpu", copy=True).numpy()


class AudioEffectGraph:
    """Composes a spatial effect and an equalizer effect.

    `spatial` must expose `is_ready: bool` and
    `process(x: [B, C, n]) -> [B, 2, n]`.

    EQ lowering: batch == 1 keeps the host float64 processor; batch > 1
    defaults to the batched device EQ on `device` (one step per callback
    instead of a B-long Python loop). Pass `equalizer=` to override either
    way.
    """

    def __init__(
        self,
        spatial,
        equalizer=None,
        config: AirwaveConfig = DEFAULT_CONFIG,
        batch: int = 1,
        device: "torch.device | str" = DEFAULT_DEVICE,
    ) -> None:
        self.spatial = spatial
        if equalizer is None:
            equalizer = (
                DeviceEqualizerEffect(config, batch=batch, device=device)
                if batch > 1 else EqualizerEffect(config, batch=batch)
            )
        self.equalizer = equalizer
        self.config = config
        self._equalizer_active = False

    def prepare(
        self,
        output_sample_rate: float,
        equalizer_definition: Optional[EqualizerDefinition],
    ) -> AudioEffectPreparationResult:
        runnable: Set[str] = set()
        if self.spatial.is_ready:
            runnable.add(SPATIAL)
        try:
            self.equalizer.prepare(equalizer_definition, output_sample_rate)
            self._equalizer_active = equalizer_definition is not None
            if equalizer_definition is not None:
                runnable.add(EQUALIZER)
            return AudioEffectPreparationResult(frozenset(runnable), None)
        except Exception as err:  # noqa: BLE001 — the non-fatal contract
            self._equalizer_active = False
            return AudioEffectPreparationResult(
                frozenset(runnable), _warning_from_error(equalizer_definition, err)
            )

    def update_equalizer(
        self, definition: Optional[EqualizerDefinition]
    ) -> AudioEffectPreparationResult:
        runnable: Set[str] = set()
        if self.spatial.is_ready:
            runnable.add(SPATIAL)
        try:
            self.equalizer.set_target(definition)
            self._equalizer_active = True  # keep for the unity ramp
            if definition is not None:
                runnable.add(EQUALIZER)
            return AudioEffectPreparationResult(frozenset(runnable), None)
        except Exception as err:  # noqa: BLE001 — the non-fatal contract
            # Keep the EQ in the callback for the unity ramp (swift
            # :147-151), but only if it was ever prepared: a never-prepared
            # equalizer has no target to ramp from.
            prepared = bool(
                getattr(self.equalizer, "processors", None)
                or getattr(self.equalizer, "runtime", None)
            )
            self._equalizer_active = prepared
            return AudioEffectPreparationResult(
                frozenset(runnable), _warning_from_error(definition, err)
            )

    @property
    def equalizer_active(self) -> bool:
        return self._equalizer_active

    def process(self, x: np.ndarray) -> np.ndarray:
        """x [B, C, n] -> y [B, 2, n]."""
        x = np.asarray(x, np.float32)
        B, C, n = x.shape
        if n == 0:
            return np.zeros((B, 2, 0), np.float32)
        if n > self.config.max_frames_per_callback:
            raise ValueError(f"callback of {n} frames exceeds "
                             f"{self.config.max_frames_per_callback}")

        if self.spatial.is_ready:
            y = self.spatial.process(x)
            if self._equalizer_active:
                y = self._run_equalizer(y)
            return y

        # Passthrough with mono duplication (zero latency).
        if C >= 2:
            y = x[:, :2, :].copy()
        else:
            y = np.concatenate([x, x], axis=1)
        if self._equalizer_active:
            y = self._run_equalizer(y)
        return y

    def _run_equalizer(self, y: np.ndarray) -> np.ndarray:
        if hasattr(self.equalizer, "process_batch"):
            return self.equalizer.process_batch(y)
        out = np.empty_like(y)
        for b in range(y.shape[0]):
            out[b, 0], out[b, 1] = self.equalizer.process(
                y[b, 0], y[b, 1], stream=b
            )
        return out
