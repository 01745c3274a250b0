"""StreamPool: the multi-stream serving engine (PyTorch).

Port of airwave_tpu/runtime/stream_pool.py for one profile: ragged
per-stream ingest through the native C++ assembler, dense masked device
steps, per-stream drain with the reference's underflow contract. One pool
shares one (HRIR, EQ) preset set and sample rate across its lanes; the
per-stream lifecycle is attach/push/pump/pull/detach. A stream advances
only when a full step of its own input exists, and the shared-cursor ring
step preserves idle lanes' carries exactly (masked slot write, then a
per-lane roll that repays the alignment debt when the lane rejoins).

Two serving tiers:
  - blocks_per_step=1 (default): zero added latency, the shared-cursor
    ring step (variants "ring", "ring_all", "ring_id").
  - blocks_per_step=M: the throughput tier. Each round renders M blocks
    per lane on the bake path's paged delay line with the EQ folded into
    the synthesis DFT; idle lanes recycle their oldest page and are
    re-aligned page-granularly at rejoin ("paged", "paged_all",
    "paged_id").

EQ retargets (set_equalizer) run the 20 ms crossfade through the port's
EqualizerRuntime, with the reference's semantics: lanes rendering during
the ramp crossfade per sample, a lane idle across the whole ramp hears the
new target when it resumes, and a lane attaching mid-ramp hears the target
directly.

Deliberate differences from the JAX pool:
  - No harvest buckets and no sentinel rows. XLA needed bucketed shapes to
    reuse compiled steps, and dropped the sentinel rows' scatter with
    mode="drop"; PyTorch has no such mode (an out-of-range index_copy_
    raises on the CPU and is a device-side assert on the card). The port
    scatters exactly the k harvested rows and rolls exactly the rejoining
    lanes.
  - The harvest is written by the assembler straight into a host staging
    buffer (pinned on the card) and uploaded with non_blocking copies; two
    buffers alternate, and a buffer is refilled only after the CUDA event
    recorded behind its last upload has completed. Rendered rows come back
    the same way, and delivery, deferred by one round so the copy overlaps
    the next round's work, waits on that round's event before it reads.
  - The assembler is always the native one: if it cannot be built the
    pool raises (native.AssemblerBuildError), as a kernel that cannot be
    built raises.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
profile groups (`profiles=`), the device mesh (`mesh=`), HRIR hot-swap
(`set_renderer`, `prewarm(include_hotswap=True)`) and checkpointing
(`snapshot`, `restore`, `state_like`).
"""

from __future__ import annotations

from collections import Counter, deque
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.device import (DEFAULT_DEVICE, apply_precision_policy,
                                      resolve_device)
from airwave_tpu_torch.graph.eq_runtime import EqualizerRuntime
from airwave_tpu_torch.graph.renderer import RendererState
from airwave_tpu_torch.io.apo import EqualizerDefinition
from airwave_tpu_torch.kernels import mac_kmajor
from airwave_tpu_torch.models.binaural import ChainOperands
from airwave_tpu_torch.native import RaggedAssembler
from airwave_tpu_torch.ops import eq_block, upols

RING_VARIANTS = ("ring", "ring_all", "ring_id")
PAGED_VARIANTS = ("paged", "paged_all", "paged_id")

_ROADMAP_HOTSWAP = "HRIR hot-swap (ROADMAP Queue 1 item 12)"
_ROADMAP_SNAPSHOT = "pool snapshot/restore/resize (ROADMAP Queue 1 item 13)"
_ROADMAP_GROUPS = "profile groups (ROADMAP Queue 1 item 14)"
_ROADMAP_MESH = "multi-GPU pools (ROADMAP Queue 1 item 17)"


class PoolState(NamedTuple):
    conv: "upols.ConvState | upols.PagedConvState"
    eq: eq_block.EqState


def _scatter_rows(blocks: torch.Tensor, idx: torch.Tensor,
                  batch: int) -> torch.Tensor:
    """The dense [batch, ...] input with the k harvested rows at idx (a
    distinct, in-range index per row) and zeros elsewhere."""
    x = blocks.new_zeros((batch,) + tuple(blocks.shape[1:]))
    return x.index_copy_(0, idx, blocks)


def _lane_mask(idx: torch.Tensor, batch: int) -> torch.Tensor:
    return torch.zeros(batch, dtype=torch.bool,
                       device=idx.device).index_fill_(0, idx, True)


def _where_lanes(mask: torch.Tensor, new: eq_block.EqState,
                 old: eq_block.EqState) -> eq_block.EqState:
    """Stepped lanes take the new EQ state, idle lanes keep theirs (the
    int32 counter stays int32)."""
    m = mask[:, None, None]
    return eq_block.EqState(
        s_from=torch.where(m, new.s_from, old.s_from),
        s_to=torch.where(m, new.s_to, old.s_to),
        counter=torch.where(mask, new.counter, old.counter),
    )


def pool_step_body(conv_params: upols.ConvParams,
                   eq_from: eq_block.EqParams, eq_to: eq_block.EqParams,
                   state: PoolState, blocks: torch.Tensor, idx: torch.Tensor,
                   transition_length: int, eq_enabled: bool,
                   eq_crossfading: bool, variant: str = "ring",
                   operands: Optional[ChainOperands] = None):
    """One pool round: scatter the k harvested rows into the dense batch,
    step the (masked) chain, gather the harvested rows back.

    blocks [k, S, T] (ring) or [k, S, M, T] (paged), idx [k] int64 distinct
    lanes -> (state', y_rows [k, E, T] or [k, M, E, T]).

    "ring" masks the lanes that were not harvested (their slot and EQ state
    are preserved). "ring_all" runs when every attached lane is harvested:
    free lanes' garbage is harmless (attach resets a lane), so the masking
    is skipped. "ring_id" additionally has idx == arange(B): the rows ARE
    the dense batch, so the scatter and gather are skipped too. The paged
    variants are the same three for the M-block tier (_pool_round_paged).

    The ring step writes state.conv's delay line in place
    (upols.conv_step): the state passed in is consumed. `operands` are the
    bank-derived MAC and synthesis operands (built when not given)."""
    if variant in PAGED_VARIANTS:
        return _pool_round_paged(conv_params, eq_from, eq_to, state, blocks,
                                 idx, transition_length, eq_enabled,
                                 eq_crossfading, variant, operands)
    if variant not in RING_VARIANTS:
        raise ValueError(f"unknown pool step variant {variant!r}")
    conv_state, eq_state = state
    B = conv_state.fdl.shape[-1]
    identity = variant == "ring_id"
    if identity and blocks.shape[0] != B:
        raise ValueError(f"ring_id needs all {B} lanes, got {blocks.shape[0]}")
    x = blocks if identity else _scatter_rows(blocks, idx, B)
    mask = _lane_mask(idx, B) if variant == "ring" else None
    bank, synth = (operands.bank, operands.synth) if operands else (None, None)
    conv_state, y = upols.conv_step(conv_params, conv_state, x, bank, synth,
                                    active_mask=mask)
    if eq_enabled:
        new_eq, y = eq_block.eq_step(eq_from, eq_to, eq_state, y,
                                     transition_length, eq_crossfading)
        eq_state = new_eq if mask is None else _where_lanes(mask, new_eq,
                                                            eq_state)
    y_rows = y if identity else y.index_select(0, idx)
    return PoolState(conv_state, eq_state), y_rows


def _pool_round_paged(conv_params, eq_from, eq_to, state, blocks, idx,
                      transition_length, eq_enabled, eq_crossfading,
                      variant, operands=None):
    """One multi-block round: blocks [k, S, M, T] -> y_rows [k, M, E, T].

    The spatial stage is the bake path's paged step. In steady state
    (eq_crossfading=False) the EQ's FIR and state drive are folded into the
    synthesis weights (eq_block.eq_folded_paged_round); during a ramp the
    plain synthesis runs and the M blocks go through eq_step in order.
    "paged" preserves idle lanes by recycling their oldest page."""
    conv_state, eq_state = state
    B = conv_state.pages[0].shape[-1]
    M = blocks.shape[2]
    identity = variant == "paged_id"
    if identity and blocks.shape[0] != B:
        raise ValueError(f"paged_id needs all {B} lanes, got {blocks.shape[0]}")
    x = blocks if identity else _scatter_rows(blocks, idx, B)
    mask = _lane_mask(idx, B) if variant == "paged" else None
    bank = operands.bank if operands else None
    if eq_enabled and not eq_crossfading:
        conv_state, new_eq, y = eq_block.eq_folded_paged_round(
            conv_params, eq_to, conv_state, eq_state, x, bank,
            operands.synth_folded if operands else None, active_mask=mask)
    else:
        conv_state, y = upols.conv_step_paged(
            conv_params, conv_state, x, bank,
            operands.synth if operands else None, active_mask=mask)
        new_eq = eq_state
        if eq_enabled:
            outs = []
            for m in range(M):
                new_eq, ym = eq_block.eq_step(eq_from, eq_to, new_eq, y[:, m],
                                              transition_length,
                                              eq_crossfading)
                outs.append(ym)
            y = torch.stack(outs, dim=1)
    if eq_enabled:
        eq_state = new_eq if mask is None else _where_lanes(mask, new_eq,
                                                            eq_state)
    y_rows = y if identity else y.index_select(0, idx)
    return PoolState(conv_state, eq_state), y_rows


class _HostSlot:
    """Host staging buffers for one round's upload or download: pinned on a
    card, so their copies run asynchronously, with the CUDA event recorded
    behind the last copy that used them. wait() returns once that copy has
    completed; on the CPU copies are synchronous and there is no event.
    `tensors` and their numpy views `arrays` follow `specs`, a sequence of
    (shape, dtype)."""

    def __init__(self, device: torch.device, *specs) -> None:
        pinned = device.type == "cuda"
        self.tensors = [torch.empty(shape, dtype=dtype, pin_memory=pinned)
                        for shape, dtype in specs]
        self.arrays = [t.numpy() for t in self.tensors]
        self.event = torch.cuda.Event() if pinned else None

    def record(self) -> None:
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class StreamPool:
    def __init__(
        self,
        max_streams: int,
        sample_rate: float,
        renderer: Optional[RendererState] = None,
        eq_definition: Optional[EqualizerDefinition] = None,
        block_size: int = 512,
        ring_blocks: int = 16,
        config: AirwaveConfig = DEFAULT_CONFIG,
        mesh=None,
        blocks_per_step: int = 1,
        profiles=None,
        device: "torch.device | str" = DEFAULT_DEVICE,
    ) -> None:
        """A pool of `max_streams` lanes on `device` (the card by default;
        pass device="cpu" for the CPU). The renderer's conv params are
        moved to the device.

        `blocks_per_step=M > 1` is the throughput tier (module docstring):
        a lane advances only when M full blocks of its input exist, so
        output latency grows to up to M blocks. It needs a renderer
        prepared with lookahead=M. `mesh` and `profiles` are not ported
        yet and raise NotImplementedError."""
        if profiles is not None:
            raise NotImplementedError(f"{_ROADMAP_GROUPS} is not ported yet")
        if mesh is not None:
            raise NotImplementedError(f"{_ROADMAP_MESH} is not ported yet")
        if renderer is None:
            raise TypeError("renderer is required")
        self.device = resolve_device(device)
        apply_precision_policy()
        self.max_streams = int(max_streams)
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.blocks_per_step = int(blocks_per_step)
        self.config = config
        if self.blocks_per_step < 1:
            raise ValueError(f"blocks_per_step must be >= 1, got "
                             f"{blocks_per_step}")
        self._check_renderer_lookahead(renderer)
        self.renderer = renderer
        self._conv_params = upols.ConvParams(*(
            t.to(self.device) for t in upols.pad_conv_params(
                renderer.conv_params, renderer.partition_count)))
        kp = upols.padded_bin_count(self.block_size)
        M = self.blocks_per_step
        if M > 1:
            bank = upols.paged_bank(self._conv_params, M, kp)
            # One full rotation of a lane's carry is the identity: n_pages
            # rounds for the paged line, P2 cursor advances for the ring.
            self._lane_cycle = renderer.partition_count // M
        else:
            bank = upols.single_block_bank(self._conv_params, kp)
            self._lane_cycle = renderer.partition_count
        self._bank = bank
        self._synth = upols.project_weights(self._conv_params, kp)
        self._folded = (None, None)  # (eq params, synthesis with them folded)

        speakers = renderer.num_speakers
        # Rings hold at least two full steps so a lane can buffer the next
        # round while one is in flight.
        capacity = block_size * max(int(ring_blocks), 2 * M)
        self.assembler = RaggedAssembler(max_streams, speakers, block_size,
                                         capacity=capacity, impl="native")
        self._out = RaggedAssembler(max_streams, 2, block_size,
                                    capacity=capacity, impl="native")
        self.eq_runtime = EqualizerRuntime(sample_rate, block_size,
                                           config.eq_state_dim, config,
                                           device=self.device)
        self._eq_enabled = eq_definition is not None
        if eq_definition is not None:
            self.eq_runtime.set_target(eq_definition)
        # Lanes attached since the last device reset: attach is host
        # bookkeeping, and the zeroing of fresh lanes' carry rows is one
        # masked device op at the next round (_flush_attach_resets).
        self._reset_pending = np.zeros(self.max_streams, bool)
        self._state = self._fresh_state()
        self._attached: Dict[int, bool] = {}
        self._attached_mask = np.zeros(self.max_streams, bool)
        self._identity_idx = np.arange(self.max_streams, dtype=np.int32)
        self._free = list(range(self.max_streams - 1, -1, -1))
        # debt[b] counts the cursor advances (ring) or rounds (paged) a
        # lane sat out since it last stepped; a harvested lane with debt
        # not a multiple of the cycle is rolled into alignment first.
        self._debt = np.zeros(self.max_streams, np.int64)
        # Rendered blocks whose output ring filled between the harvest-time
        # space check and delivery (an unlocked concurrent pull) stash here
        # in order and re-flush on pull. Serialized use never fills it.
        self._pending_out: Dict[int, deque] = {}
        frames = self.step_frames
        self._uploads = [
            _HostSlot(self.device,
                      ((self.max_streams, speakers, frames), torch.float32),
                      ((self.max_streams,), torch.int64))
            for _ in range(2)]
        self._downloads = [
            _HostSlot(self.device,
                      ((self.max_streams, 2, frames), torch.float32))
            for _ in range(2)]
        self._turn = 0
        self.rounds = 0
        self.blocks_rendered = 0
        self.render_errors = 0
        self.debt_rolls = 0
        self.variant_rounds: Counter = Counter()

    @property
    def step_frames(self) -> int:
        """Frames a lane advances per pump round (blocks_per_step * block)."""
        return self.blocks_per_step * self.block_size

    @property
    def _paged(self) -> bool:
        return self.blocks_per_step > 1

    def _check_renderer_lookahead(self, renderer: RendererState) -> None:
        if self.blocks_per_step == 1:
            return
        if renderer.lookahead != self.blocks_per_step:
            raise ValueError(
                f"blocks_per_step={self.blocks_per_step} needs a renderer "
                f"prepared with lookahead={self.blocks_per_step} "
                f"(got lookahead={renderer.lookahead}; see prepare_renderer)"
            )
        if renderer.partition_count % self.blocks_per_step:
            raise ValueError(
                f"renderer partition count {renderer.partition_count} is "
                f"not divisible by blocks_per_step={self.blocks_per_step}"
            )

    @torch.inference_mode()
    def _fresh_state(self) -> PoolState:
        r = self.renderer
        if self._paged:
            conv = upols.make_conv_state_paged(
                self.max_streams, r.num_speakers, r.partition_count,
                self.block_size, self.blocks_per_step, self.device)
        else:
            conv = upols.make_conv_state(self.max_streams, r.num_speakers,
                                         r.partition_count, self.block_size,
                                         self.device)
        return PoolState(conv=conv, eq=eq_block.make_eq_state(
            self.max_streams, 2, self.config.eq_state_dim, self.device))

    def _operands(self, eq_to: eq_block.EqParams) -> ChainOperands:
        """The bank-derived operands of a round; the paged tier's folded
        synthesis depends on the active EQ target and is rebuilt when it
        changes."""
        synth_folded = None
        if self._paged and self._eq_enabled:
            params, synth_folded = self._folded
            if params is not eq_to:
                synth_folded = upols.project_weights(
                    self._conv_params, self._bank.shape[1],
                    eq_block.fold_post(eq_to))
                self._folded = (eq_to, synth_folded)
        return ChainOperands(self._bank, self._synth, synth_folded)

    # --- stream lifecycle --------------------------------------------------

    def attach(self) -> int:
        """Claim a free lane."""
        if not self._free:
            raise RuntimeError("pool is full")
        stream = self._free.pop()
        self._attached[stream] = True
        self._attached_mask[stream] = True
        self.assembler.reset_stream(stream)
        self._out.reset_stream(stream)
        # The device-row zeroing is deferred and batched (pump flushes it
        # before every round). A zeroed lane is rotation-invariant, so a
        # fresh stream joins with no alignment debt.
        self._reset_pending[stream] = True
        self._debt[stream] = 0
        return stream

    def detach(self, stream: int) -> None:
        if self._attached.pop(stream, None):
            self._attached_mask[stream] = False
            self._free.append(stream)
            self._pending_out.pop(stream, None)
            self.assembler.reset_stream(stream)
            self._out.reset_stream(stream)

    @torch.inference_mode()
    def _flush_attach_resets(self) -> None:
        """Zero the carry rows of every lane attached since the last flush,
        as one masked device op."""
        if not self._reset_pending.any():
            return
        # COPY the mask: torch.from_numpy aliases the numpy buffer, which
        # is cleared right below.
        m = torch.from_numpy(self._reset_pending.copy()).to(self.device)
        reset = upols.conv_reset_paged if self._paged else upols.conv_reset
        eq = eq_block.eq_reset(self._state.eq, m)
        # A fresh lane hears the ACTIVE target directly: idle its counter so
        # an in-flight ramp blends it at weight 1.0 on the 'to' cascade.
        eq = eq._replace(counter=eq.counter.masked_fill(
            m, eq_block.COUNTER_IDLE))
        self._state = PoolState(conv=reset(self._state.conv, m), eq=eq)
        self._reset_pending[:] = False

    # --- control -----------------------------------------------------------

    def set_equalizer(self, definition: Optional[EqualizerDefinition]) -> None:
        """Retarget the pool EQ (the 20 ms crossfade runs in the next
        rounds). `None` on an EQ-less pool stays a no-op; `None` on an
        active pool crossfades to unity and keeps the EQ in the step."""
        if definition is None and not self._eq_enabled:
            return
        self.eq_runtime.set_target(definition)
        self._eq_enabled = True

    def set_renderer(self, renderer, group=None, crossfade=True):
        raise NotImplementedError(f"{_ROADMAP_HOTSWAP} is not ported yet")

    def snapshot(self, materialize=True):
        raise NotImplementedError(f"{_ROADMAP_SNAPSHOT} is not ported yet")

    def restore(self, snap, resize=False):
        raise NotImplementedError(f"{_ROADMAP_SNAPSHOT} is not ported yet")

    def state_like(self, max_streams):
        raise NotImplementedError(f"{_ROADMAP_SNAPSHOT} is not ported yet")

    # --- data plane --------------------------------------------------------

    def push(self, stream: int, chunk: np.ndarray) -> None:
        """chunk: [speakers, n], [layout_channels, n] (unmapped layout
        channels are dropped) or [1, n] mono, duplicated."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 1:
            chunk = chunk[None]
        speakers = self.renderer.num_speakers
        if chunk.shape[0] == 1 and speakers > 1:
            chunk = np.repeat(chunk, speakers, axis=0)
        else:
            chunk = self.renderer.select_input(chunk)
        self.assembler.push(stream, chunk)

    def push_many(self, streams, chunks: np.ndarray) -> None:
        """Batch ingest: chunks [k, C, n] onto k streams in one native call
        (all or nothing on ring space). C may be the speaker count, the
        layout's channel count (unmapped channels drop) or 1 (mono)."""
        chunks = np.asarray(chunks, np.float32)
        speakers = self.renderer.num_speakers
        if chunks.shape[1] == 1 and speakers > 1:
            chunks = np.repeat(chunks, speakers, axis=1)
        elif (chunks.shape[1] == self.renderer.layout_channels
              and chunks.shape[1] != speakers):
            chunks = chunks[:, list(self.renderer.input_indices)]
        self.assembler.push_many(streams, chunks)

    def pull_many(self, streams, frames: int) -> np.ndarray:
        """Batch drain: [k, 2, frames], zero-filled per stream on underflow
        (per-stream pulls while any stashed blocks exist, to keep order)."""
        if not self._pending_out:
            return self._out.pop_many(streams, frames)
        return np.stack([self.pull(int(s), frames) for s in streams])

    @torch.inference_mode()
    def prewarm(self, include_hotswap: bool = False) -> None:
        """Build the kernel and load the cuBLAS paths before traffic: each
        step variant runs once (both EQ modes when the EQ is on) on a
        throwaway state, and one lane roll. The pool's own state, cursor,
        debt and EQ machine are untouched."""
        if include_hotswap:
            raise NotImplementedError(f"{_ROADMAP_HOTSWAP} is not ported yet")
        if self.device.type == "cuda":
            mac_kmajor.build()
        p = self.eq_runtime.active.params
        B, S = self.max_streams, self.renderer.num_speakers
        shape = ((B, S, self.blocks_per_step, self.block_size) if self._paged
                 else (B, S, self.block_size))
        blocks = torch.zeros(shape, device=self.device)
        idx = torch.arange(B, device=self.device)
        variants = PAGED_VARIANTS if self._paged else RING_VARIANTS
        for crossfading in ((False, True) if self._eq_enabled else (False,)):
            for variant in variants:
                pool_step_body(self._conv_params, p, p, self._fresh_state(),
                               blocks, idx, self.eq_runtime.transition_length,
                               self._eq_enabled, crossfading, variant,
                               self._operands(p))
        roll = (upols.conv_roll_lanes_paged if self._paged
                else upols.conv_roll_lanes)
        roll(self._fresh_state().conv, idx[:1], idx[:1])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _begin_eq_round(self, eq_state):
        """Run the EQ control protocol for one round; returns (eq_state',
        params_from, params_to, crossfading)."""
        # The pool is its own control thread: drain the retirement handoff
        # every round, or the single-slot backpressure wedges the third
        # and every later retarget.
        rt = self.eq_runtime
        rt.drain_retired_states()
        eq_state, p_from, p_to, _ = rt.begin_block(eq_state)
        crossfading = rt.is_transitioning or rt.pending_target is not None
        return eq_state, p_from, p_to, crossfading

    @torch.inference_mode()
    def pump(self, max_rounds: int = 64, on_deliver=None) -> int:
        """Render while any stream has a full step. Returns rounds run.

        `on_deliver`, if given, is called (no arguments) after each
        round's output lands in the output rings. Per round only the
        harvested rows cross the host/device boundary, and round r's
        output is delivered after round r+1 has been dispatched, so its
        copy to the host overlaps the next round's work. The harvest gating
        counts the one in-flight undelivered step against the free space,
        so backpressure is the same as with immediate delivery.

        On a failure the pool rebuilds a fresh state (blocks harvested for
        in-flight rounds are lost and read as underflow zeros), counts it
        in render_errors and re-raises."""
        rounds = 0
        pending = None  # (indices, host slot) awaiting delivery
        inflight = np.zeros(self.max_streams, bool)
        M, S = self.blocks_per_step, self.renderer.num_speakers
        step_frames = self.step_frames
        try:
            while rounds < max_rounds and self.assembler.ready_count() > 0:
                self._flush_attach_resets()
                # Harvest only streams whose output ring can take the step
                # (a slow reader's producer then meets input backpressure).
                free = self._out.out_free_all()
                allow = (free - inflight * step_frames) >= step_frames
                up = self._uploads[self._turn]
                down = self._downloads[self._turn]
                self._turn ^= 1
                up.wait()  # its last upload has left the buffers
                indices, _ = self.assembler.harvest_allowed(
                    self.max_streams, allow, frames=step_frames,
                    out=up.arrays[0])
                k = len(indices)
                if k == 0:
                    break
                self._roll_rejoining(indices)
                up.arrays[1][:k] = indices
                blocks, idx = (t[:k].to(self.device, non_blocking=True)
                               for t in up.tensors)
                up.record()
                if M > 1:
                    # [k, S, M*T] -> [k, S, M, T]: ring pops are frame-major
                    # per channel, so the view is free.
                    blocks = blocks.view(k, S, M, self.block_size)

                eq_state, p_from, p_to, crossfading = self._begin_eq_round(
                    self._state.eq)
                variant = self._variant(indices)
                state, y_rows = pool_step_body(
                    self._conv_params, p_from, p_to,
                    PoolState(self._state.conv, eq_state), blocks, idx,
                    self.eq_runtime.transition_length, self._eq_enabled,
                    crossfading, variant, self._operands(p_to))
                self._state = state
                self.eq_runtime.after_block(step_frames)
                self._debt[self._attached_mask] += 1
                self._debt[indices] = 0

                if M > 1:  # [k, M, E, T] -> [k, E, M*T] (channel planes)
                    y_rows = y_rows.transpose(1, 2).reshape(k, 2, step_frames)
                down.wait()
                down.tensors[0][:k].copy_(y_rows, non_blocking=True)
                down.record()
                if pending is not None:
                    self._deliver(*pending)
                    inflight[pending[0]] = False
                    if on_deliver is not None:
                        on_deliver()
                pending = (indices, down)
                inflight[indices] = True
                self.variant_rounds[variant] += 1
                self.rounds += 1
                self.blocks_rendered += k * M
                rounds += 1
            if pending is not None:
                self._deliver(*pending)
                pending = None
                if on_deliver is not None:
                    on_deliver()
        except Exception:
            # The carry may be half-updated in place: rebuild fresh
            # per-stream state (the reference's recovery is likewise a
            # fresh pipeline); the pool stays usable for the next round.
            self._state = self._fresh_state()
            self._debt[:] = 0
            self._reset_pending[:] = False  # the fresh state is already zero
            self.render_errors += 1
            raise
        return rounds

    def _variant(self, indices: np.ndarray) -> str:
        k = len(indices)
        tier = "paged" if self._paged else "ring"
        if k != len(self._attached):
            return tier
        if k == self.max_streams and np.array_equal(indices,
                                                    self._identity_idx):
            return f"{tier}_id"
        return f"{tier}_all"

    def _roll_rejoining(self, indices: np.ndarray) -> None:
        """Re-align the harvested lanes that owe alignment debt: exactly
        those lanes, in place on the carry."""
        shift = self._debt[indices] % self._lane_cycle
        rejoin = shift != 0
        if not rejoin.any():
            return
        lanes = torch.from_numpy(indices[rejoin].astype(np.int64))
        shifts = torch.from_numpy(shift[rejoin])
        roll = (upols.conv_roll_lanes_paged if self._paged
                else upols.conv_roll_lanes)
        roll(self._state.conv, lanes.to(self.device), shifts.to(self.device))
        self.debt_rolls += 1

    def _deliver(self, indices: np.ndarray, slot: _HostSlot) -> None:
        """Queue a round's rendered rows once their copy to the host has
        completed. Harvest gating guarantees ring space, so one atomic
        scatter is the fast path; an unlocked pull racing the round can
        shrink a ring, and the affected blocks then stash in order."""
        slot.wait()
        blocks = slot.arrays[0][: len(indices)]
        if not self._pending_out:
            try:
                self._out.scatter(indices, blocks)
                return
            except OverflowError:
                pass
        for j, stream in enumerate(int(s) for s in indices):
            queue = self._pending_out.get(stream)
            if queue is None and self._out.try_push_out(stream, blocks[j]):
                continue
            if queue is None:
                queue = self._pending_out.setdefault(stream, deque())
            queue.append(np.array(blocks[j]))

    def _flush_pending(self, stream: int) -> None:
        queue = self._pending_out.get(stream)
        while queue and self._out.try_push_out(stream, queue[0]):
            queue.popleft()
        if queue is not None and not queue:
            self._pending_out.pop(stream, None)

    def pull(self, stream: int, frames: int) -> np.ndarray:
        """Drain rendered stereo; zero-fills on underflow (latency
        contract)."""
        pieces = []
        left = frames
        while left > 0:
            self._flush_pending(stream)
            avail = self._out.out_available(stream)
            if avail <= 0:
                break
            take = min(left, avail)
            pieces.append(self._out.pop(stream, take))
            left -= take
            if stream not in self._pending_out:
                break
        if left > 0 or not pieces:
            pieces.append(self._out.pop(stream, left))  # zero-fills
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, 1)

    def available(self, stream: int) -> int:
        return self._out.out_available(stream) + sum(
            b.shape[1] for b in self._pending_out.get(stream, ()))

    def stats(self) -> dict:
        """Host-side counters only: reading them never touches the device."""
        attached = self._attached_mask
        return {
            "max_streams": self.max_streams,
            "attached": len(self._attached),
            "blocks_per_step": self.blocks_per_step,
            "rounds": self.rounds,
            "blocks_rendered": self.blocks_rendered,
            "render_errors": self.render_errors,
            "stashed_streams": len(self._pending_out),
            "lanes_in_debt": int(
                (self._debt[attached] % self._lane_cycle != 0).sum()),
            "debt_rolls": self.debt_rolls,
            "variant_rounds": dict(self.variant_rounds),
            "eq_transitioning": self.eq_runtime.is_transitioning,
        }
