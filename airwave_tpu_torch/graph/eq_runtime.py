"""Host-side equalizer runtime: target publication + crossfade state machine.

Port of airwave_tpu/graph/eq_runtime.py. The per-sample crossfade math
lives in the device step (ops/eq_block.eq_step: dual cascade + exact ramp
blend); this class reproduces the reference's control protocol
(Airwave/ParametricEqualizerProcessor.swift:121-407) at block granularity:

  - `set_target` publishes a prepared cascade (newest wins while a ramp is
    in flight)
  - a publication "lock" seam lets tests simulate control/render
    contention: while held, the render path keeps the prior target
  - finished transitions retire the outgoing cascade into a single-slot
    handoff; if the slot is full the next transition is deferred until the
    control thread drains it
  - `reset` is deferred to the next block boundary

The state machine is the reference's host code, unchanged; only the
cascade params are torch tensors, on the runtime's device. `snapshot` and
`restore` checkpoint the render-side crossfade machine as definitions and
designs, from which the cascades are rebuilt.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.io.apo import EqualizerDefinition
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import eq_block
from airwave_tpu_torch.utils.errors import EqInvalidSampleRate

_IDLE = eq_block.COUNTER_IDLE


class PreparedEq(NamedTuple):
    """A prepared cascade target (analog of ParametricEqualizerState).
    `design` keeps the (preamp, coeffs) cascade design."""

    params: eq_block.EqParams
    definition: Optional[EqualizerDefinition]
    sample_rate: float
    design: tuple = ((), ())


class EqualizerRuntime:
    def __init__(
        self,
        sample_rate: float,
        block_size: int = 512,
        state_dim: int = 128,
        config: AirwaveConfig = DEFAULT_CONFIG,
        device: "torch.device | str" = DEFAULT_DEVICE,
    ) -> None:
        if not (math.isfinite(sample_rate) and sample_rate > 0):
            raise EqInvalidSampleRate()
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.state_dim = int(state_dim)
        self.transition_length = config.transition_length(sample_rate)

        unity_design = bd.design_cascade(None, sample_rate)
        self.unity = PreparedEq(
            eq_block.unity_eq_params(block_size, state_dim, self.device),
            None, sample_rate, unity_design,
        )
        # Render-side view.
        self.active: PreparedEq = self.unity          # == params_to when idle
        self.transition_from: Optional[PreparedEq] = None
        self.pending_target: Optional[PreparedEq] = None
        self.observed_target: Optional[PreparedEq] = None
        self._samples_into_transition = _IDLE

        # Control<->render slots.
        self._published: Optional[PreparedEq] = None
        self._audio_thread_target: Optional[PreparedEq] = None
        self._retired: Optional[PreparedEq] = None
        self._pending_retirement: Optional[PreparedEq] = None
        self._reset_requested = False
        self._publication_locked = False

    # --- control-thread API ------------------------------------------------

    def prepare(self, definition: Optional[EqualizerDefinition]) -> PreparedEq:
        preamp, coeffs = bd.design_cascade(definition, self.sample_rate)
        params = eq_block.make_eq_params(coeffs, preamp, self.block_size,
                                         self.state_dim, device=self.device)
        return PreparedEq(params, definition, self.sample_rate,
                          (preamp, coeffs))

    def publish(self, prepared: PreparedEq) -> None:
        if prepared.sample_rate != self.sample_rate:
            raise EqInvalidSampleRate()
        self._published = prepared

    def set_target(self, definition: Optional[EqualizerDefinition]) -> None:
        self.publish(self.prepare(definition))

    def reset(self) -> None:
        self._reset_requested = True

    def drain_retired_states(self) -> None:
        self._retired = None

    def hold_publication_lock_for_testing(self, held: bool) -> None:
        self._publication_locked = held

    @property
    def is_transitioning(self) -> bool:
        return self.transition_from is not None

    # --- checkpoint / resume -------------------------------------------------

    def snapshot(self) -> dict:
        """The render-side crossfade machine: the active cascade, the one it
        ramps from, the queued newest-wins target and the ramp clock.
        Control-plane transients (an unobserved publication, the retirement
        slots) are not captured: like in-flight audio they re-establish on
        the next control action. Definitions and designs are stored, not
        params: `prepare` is deterministic, so restore rebuilds the same
        cascades."""
        def pack(p: Optional[PreparedEq]):
            # The design is packed too: a PreparedEq built directly (no
            # definition, custom params through publish()) has nothing else
            # to be rebuilt from and must not come back as unity.
            if p is None:
                return None
            if (p.definition is None and p is not self.unity
                    and p.design == ((), ())):
                raise ValueError(
                    "cannot snapshot a definition-less PreparedEq with no "
                    "design: construct targets via prepare() or carry the "
                    "(preamp, coeffs) design"
                )
            return ("prepared", p.definition, p.design)

        return {
            "active": pack(self.active),
            "transition_from": pack(self.transition_from),
            "pending": pack(self.pending_target),
            "samples_into_transition": self._samples_into_transition,
            "reset_requested": self._reset_requested,
        }

    def restore(self, snap: dict) -> None:
        def make(item) -> Optional[PreparedEq]:
            if item is None:
                return None
            _, definition, *rest = item
            if definition is not None:
                return self.prepare(definition)
            design = rest[0] if rest else self.unity.design
            if tuple(design) == tuple(self.unity.design):
                return self.unity
            # A definition-less custom cascade (published directly): its
            # params are rebuilt from the packed design.
            preamp, coeffs = design
            params = eq_block.make_eq_params(coeffs, preamp, self.block_size,
                                             self.state_dim,
                                             device=self.device)
            return PreparedEq(params, None, self.sample_rate, (preamp, coeffs))

        self.active = make(snap["active"]) or self.unity
        self.transition_from = make(snap["transition_from"])
        self.pending_target = make(snap["pending"])
        self._samples_into_transition = int(snap["samples_into_transition"])
        self._reset_requested = bool(snap["reset_requested"])
        # A fresh control plane: nothing published, observed or retired.
        self.observed_target = None
        self._published = None
        self._audio_thread_target = None
        self._retired = None
        self._pending_retirement = None

    # --- render-side protocol (called by the engine per block) -------------

    def begin_block(self, eq_state: eq_block.EqState):
        """Run the control protocol; returns (eq_state', params_from,
        params_to, reset_applied: bool). Operates on the whole state it is
        handed (no lane masking)."""
        states, params_from, params_to, reset_now = self.begin_block_shards(
            [eq_state])
        return states[0], params_from, params_to, reset_now

    def begin_block_shards(self, eq_states: list):
        """begin_block for a state split over shards (a sharded pool's
        groups): the protocol runs once and each lane op it applies
        (reset, finish, begin) applies to every part. Returns (eq_states',
        params_from, params_to, reset_applied)."""
        eq_states = list(eq_states)
        self._observe_published_target()
        self._flush_pending_retirement()

        reset_now = False
        if self._reset_requested:
            self._reset_requested = False
            reset_now = True
            eq_states = [eq_block.eq_reset(s) for s in eq_states]

        # Finish a transition that completed in previous blocks.
        if (self.transition_from is not None
                and self._samples_into_transition >= self.transition_length):
            eq_states = self._finish_transition(eq_states)

        # Start a newly-observed transition if allowed.
        if (self.pending_target is not None
                and self.transition_from is None
                and self._pending_retirement is None):
            pending, self.pending_target = self.pending_target, None
            if pending is not self.active:
                eq_states = self._begin_transition(eq_states, pending)

        params_from = (self.transition_from.params
                       if self.transition_from is not None
                       else self.active.params)
        return eq_states, params_from, self.active.params, reset_now

    def after_block(self, frames: int) -> None:
        if self._samples_into_transition < _IDLE:
            self._samples_into_transition = min(
                self._samples_into_transition + frames, _IDLE)

    # --- internals ---------------------------------------------------------

    def _observe_published_target(self) -> None:
        if not self._publication_locked and self._published is not None:
            self._audio_thread_target = self._published

        target = self._audio_thread_target
        if target is None or target is self.observed_target:
            return
        self.observed_target = target
        if self.transition_from is not None:
            if target is not self.active:
                self.pending_target = target  # newest wins
        elif self._pending_retirement is not None:
            self.pending_target = target
        elif target is not self.active:
            self.pending_target = target  # started in begin_block

    def _begin_transition(self, eq_states: list, target: PreparedEq) -> list:
        self.transition_from = self.active
        self.active = target
        self._samples_into_transition = 0
        return [eq_block.eq_begin_transition(s) for s in eq_states]

    def _finish_transition(self, eq_states: list) -> list:
        outgoing = self.transition_from
        self.transition_from = None
        self._samples_into_transition = _IDLE
        self._retire(outgoing)
        # Idle the lanes' ramp counters: a lane that paused mid-ramp jumps
        # to the target now that the wall-clock ramp is over.
        return [eq_block.eq_finish_transition(s) for s in eq_states]

    def _retire(self, state: PreparedEq) -> None:
        if self._pending_retirement is not None:
            return
        if self._retired is None:
            self._retired = state
        else:
            self._pending_retirement = state

    def _flush_pending_retirement(self) -> None:
        if self._pending_retirement is None:
            return
        if self._retired is None:
            self._retired = self._pending_retirement
            self._pending_retirement = None
