"""Host-exact parametric EQ processor with bounded crossfades.

The port's own copy of airwave_tpu/graph/eq_processor.py (numpy only).

Faithful single-host re-implementation of
the reference's Airwave/ParametricEqualizerProcessor.swift:121-407 operating
at arbitrary callback sizes with per-sample-exact crossfade segmentation.
This is the *host* fidelity path (float64 cascade via the oracle): it serves
the EQ-only live mode (which the reference runs at callback granularity with
zero added latency, AudioEffectGraph.swift:223-237) and the exact-parity
tests. The device path is graph/eq_runtime.py + ops/eq_block.py.

Protocol parity: newest-wins target queueing, single-slot retirement with
render-side backpressure, deferred reset, publication-lock contention seam.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.io.apo import EqualizerDefinition
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu_torch.utils import errors


def prepare_state(
    definition: Optional[EqualizerDefinition], sample_rate: float
) -> EqCascadeOracle:
    """Analog of ParametricEqualizerProcessor.prepare (swift :174-217)."""
    preamp, coeffs = bd.design_cascade(definition, sample_rate)
    return EqCascadeOracle(coeffs, preamp, sample_rate)


class ParametricEqualizerProcessor:
    def __init__(
        self,
        sample_rate: float,
        max_frames_per_callback: int = 4096,
        config: AirwaveConfig = DEFAULT_CONFIG,
    ) -> None:
        if not (np.isfinite(sample_rate) and sample_rate > 0):
            raise errors.EqInvalidSampleRate()
        if not (0 < max_frames_per_callback <= config.max_frames_per_callback):
            raise errors.EqInvalidFrameCount(
                max_frames_per_callback, config.max_frames_per_callback
            )
        self.sample_rate = float(sample_rate)
        self.max_frames_per_callback = int(max_frames_per_callback)
        self.transition_length = config.transition_length(sample_rate)

        self.unity_state = prepare_state(None, sample_rate)
        self.active_state = self.unity_state
        self.transition_from: Optional[EqCascadeOracle] = None
        self.transition_to: Optional[EqCascadeOracle] = None
        self.pending_target: Optional[EqCascadeOracle] = None
        self.observed_target: Optional[EqCascadeOracle] = None
        self.audio_thread_target: Optional[EqCascadeOracle] = None
        self.transition_frame = 0
        self.pending_retirement: Optional[EqCascadeOracle] = None

        self._published: Optional[EqCascadeOracle] = None
        self._retired: Optional[EqCascadeOracle] = None
        self._reset_requested = False
        self._publication_locked = False

    # --- control thread -------------------------------------------------------

    def publish(self, state: EqCascadeOracle) -> None:
        if state.sample_rate != self.sample_rate:
            raise errors.EqInvalidSampleRate()
        self._published = state

    def set_target(self, definition: Optional[EqualizerDefinition]) -> None:
        self.publish(prepare_state(definition, self.sample_rate))

    def reset(self) -> None:
        self._reset_requested = True

    def drain_retired_states(self) -> None:
        self._retired = None

    def hold_publication_lock_for_testing(self, held: bool) -> None:
        self._publication_locked = held

    # --- render thread ----------------------------------------------------------

    def process(
        self, left: np.ndarray, right: Optional[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray]:
        left = np.asarray(left, np.float32)
        right_in = left if right is None else np.asarray(right, np.float32)
        n = len(left)
        if n == 0:
            return left.copy(), right_in.copy()
        assert n <= self.max_frames_per_callback

        self._observe_published_target()
        self._flush_pending_retirement()
        self._apply_pending_reset()

        out_l = np.empty(n, np.float32)
        out_r = np.empty(n, np.float32)
        offset = 0
        while offset < n:
            if self.transition_from is None or self.transition_to is None:
                l, r = self.active_state.process(left[offset:], right_in[offset:])
                out_l[offset:], out_r[offset:] = l, r
                return out_l, out_r

            remaining = self.transition_length - self.transition_frame
            segment = min(remaining, n - offset)
            sl = slice(offset, offset + segment)
            old_l, old_r = self.transition_from.process(left[sl], right_in[sl])
            new_l, new_r = self.transition_to.process(left[sl], right_in[sl])

            idx = np.arange(segment, dtype=np.float64)
            progress = (self.transition_frame + idx + 1.0) / self.transition_length
            inverse = 1.0 - progress
            out_l[sl] = (
                old_l.astype(np.float64) * inverse
                + new_l.astype(np.float64) * progress
            ).astype(np.float32)
            out_r[sl] = (
                old_r.astype(np.float64) * inverse
                + new_r.astype(np.float64) * progress
            ).astype(np.float32)

            self.transition_frame += segment
            offset += segment
            if self.transition_frame == self.transition_length:
                self._finish_transition()
        return out_l, out_r

    # --- internals (mirror swift :317-407) ----------------------------------------

    def _observe_published_target(self) -> None:
        if not self._publication_locked and self._published is not None:
            self.audio_thread_target = self._published

        target = self.audio_thread_target
        if target is None or target is self.observed_target:
            return
        self.observed_target = target
        if self.transition_to is not None:
            if target is not self.transition_to:
                self.pending_target = target
        elif self.pending_retirement is not None:
            self.pending_target = target
        elif target is not self.active_state:
            self._begin_transition(target)

    def _apply_pending_reset(self) -> None:
        # Reset rides its own lock in the reference (resetLock, swift :131).
        if not self._reset_requested:
            return
        self._reset_requested = False
        self.active_state.reset()
        if self.transition_from is not None:
            self.transition_from.reset()
        if self.transition_to is not None:
            self.transition_to.reset()

    def _begin_transition(self, target: EqCascadeOracle) -> None:
        if target is self.active_state:
            return
        self.transition_from = self.active_state
        self.transition_to = target
        self.transition_frame = 0

    def _finish_transition(self) -> None:
        if self.transition_from is None or self.transition_to is None:
            return
        outgoing = self.transition_from
        self.active_state = self.transition_to
        self.transition_from = None
        self.transition_to = None
        self.transition_frame = 0
        if not self._retire(outgoing):
            return
        if self.pending_target is not None:
            pending, self.pending_target = self.pending_target, None
            if pending is not self.active_state:
                self._begin_transition(pending)

    def _retire(self, state: EqCascadeOracle) -> bool:
        if self.pending_retirement is not None:
            return False
        if self._retired is None:
            self._retired = state
            return True
        self.pending_retirement = state
        return False

    def _flush_pending_retirement(self) -> None:
        if self.pending_retirement is None:
            return
        if self._retired is not None:
            return
        self._retired = self.pending_retirement
        self.pending_retirement = None
        if self.pending_target is not None:
            pending, self.pending_target = self.pending_target, None
            if pending is not self.active_state:
                self._begin_transition(pending)
