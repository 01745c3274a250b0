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

HRIR hot-swaps (set_renderer) keep every lane's conv history: the delay
line holds bank-independent input spectra, so each lane's next rendered
round runs the dual bank (upols.xfade_conv_params) and blends old -> new
per sample before the EQ. The carry's partition count is tracked apart
from the renderer's: a shorter bank is zero-padded onto the carry, and the
lane-debt modulus stays the carry's. `snapshot` and `restore` checkpoint
the carry with the host state that interprets it (debt, attached lanes,
the EQ machine); `restore(..., resize=True)` maps a snapshot of another
lane count onto this pool.

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
profile groups (`profiles=`, and so `set_renderer(..., group=g)` for a
group other than 0) and the device mesh (`mesh=`).
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


def _map_carry(fn, state) -> PoolState:
    """The pool carry with fn applied to each tensor leaf (duck-typed, so a
    snapshot's carry written by the JAX pool, with numpy leaves, maps too).
    The ring cursor stays a host integer, kept as an np.int32 as the JAX
    carry holds it."""
    conv = state.conv
    if hasattr(conv, "pages"):
        conv = upols.PagedConvState(pages=tuple(fn(p) for p in conv.pages))
    else:
        conv = upols.ConvState(fdl=fn(conv.fdl),
                               write_pos=np.int32(np.asarray(conv.write_pos)))
    eq = state.eq
    return PoolState(conv, eq_block.EqState(
        s_from=fn(eq.s_from), s_to=fn(eq.s_to), counter=fn(eq.counter)))


def _carry_leaves(state: PoolState) -> list:
    """(name, tensor) for each tensor of a pool carry, in a fixed order."""
    conv = state.conv
    named = ([(f"page {a}", p) for a, p in enumerate(conv.pages)]
             if hasattr(conv, "pages") else [("fdl", conv.fdl)])
    return named + list(zip(eq_block.EqState._fields, state.eq))


def _to_host(t: torch.Tensor) -> np.ndarray:
    # A copy even on the CPU: the pool writes its carry in place.
    return t.detach().to("cpu", copy=True).numpy()


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
                   operands: Optional[ChainOperands] = None,
                   xfade_ramp: "torch.Tensor | None" = None,
                   xfade_mask: "torch.Tensor | None" = None):
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

    `xfade_ramp` [round frames] with `xfade_mask` [B] bool runs a hot-swap
    round (StreamPool.set_renderer): conv_params is the dual bank
    (upols.xfade_conv_params, ears [0, E) OLD and [E, 2E) NEW) over the
    unchanged delay line, and masked lanes blend old -> new per sample
    before the EQ; the other lanes take the pure new half.

    The ring step writes state.conv's delay line in place
    (upols.conv_step): the state passed in is consumed. `operands` are the
    bank-derived MAC and synthesis operands (built when not given)."""
    if variant in PAGED_VARIANTS:
        return _pool_round_paged(conv_params, eq_from, eq_to, state, blocks,
                                 idx, transition_length, eq_enabled,
                                 eq_crossfading, variant, operands,
                                 xfade_ramp, xfade_mask)
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
    if xfade_ramp is not None:
        y = upols.xfade_blend(y, xfade_ramp, xfade_mask)
    if eq_enabled:
        new_eq, y = eq_block.eq_step(eq_from, eq_to, eq_state, y,
                                     transition_length, eq_crossfading)
        eq_state = new_eq if mask is None else _where_lanes(mask, new_eq,
                                                            eq_state)
    y_rows = y if identity else y.index_select(0, idx)
    return PoolState(conv_state, eq_state), y_rows


def _pool_round_paged(conv_params, eq_from, eq_to, state, blocks, idx,
                      transition_length, eq_enabled, eq_crossfading,
                      variant, operands=None, xfade_ramp=None,
                      xfade_mask=None):
    """One multi-block round: blocks [k, S, M, T] -> y_rows [k, M, E, T].

    The spatial stage is the bake path's paged step. In steady state
    (eq_crossfading=False) the EQ's FIR and state drive are folded into the
    synthesis weights (eq_block.eq_folded_paged_round); during a ramp the
    plain synthesis runs and the M blocks go through eq_step in order.
    A hot-swap round (xfade_ramp given) takes the plain path too: the
    blended signal must drive the EQ, and the fold never materializes the
    spatial output. "paged" preserves idle lanes by recycling their oldest
    page."""
    conv_state, eq_state = state
    B = conv_state.pages[0].shape[-1]
    M = blocks.shape[2]
    identity = variant == "paged_id"
    if identity and blocks.shape[0] != B:
        raise ValueError(f"paged_id needs all {B} lanes, got {blocks.shape[0]}")
    x = blocks if identity else _scatter_rows(blocks, idx, B)
    mask = _lane_mask(idx, B) if variant == "paged" else None
    bank = operands.bank if operands else None
    if eq_enabled and not eq_crossfading and xfade_ramp is None:
        conv_state, new_eq, y = eq_block.eq_folded_paged_round(
            conv_params, eq_to, conv_state, eq_state, x, bank,
            operands.synth_folded if operands else None, active_mask=mask)
    else:
        conv_state, y = upols.conv_step_paged(
            conv_params, conv_state, x, bank,
            operands.synth if operands else None, active_mask=mask)
        if xfade_ramp is not None:
            y = upols.xfade_blend(y, xfade_ramp, xfade_mask)
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
        self._k_padded = upols.padded_bin_count(self.block_size)
        # The carry's partition count. After a crossfaded shorter-HRIR swap
        # the active bank is the renderer's zero-padded onto the unchanged
        # carry, so this may exceed the renderer's own count.
        self._bank_partitions = renderer.partition_count
        self._rebuild_conv_params()
        # The hot-swap crossfade in flight: the dual bank and its operands,
        # and per lane whether its next rendered round still owes the fade.
        self._xfade_params: Optional[upols.ConvParams] = None
        self._xfade_operands: Optional[ChainOperands] = None
        self._xfade_pending = np.zeros(self.max_streams, bool)
        self._xfade_ramp: Optional[torch.Tensor] = None

        M = self.blocks_per_step
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
        # Each upload slot: the harvested rows, their lanes, and a fade
        # round's lane mask (a staged copy: the host updates _xfade_pending
        # right after the round is queued).
        self._uploads = [
            _HostSlot(self.device,
                      ((self.max_streams, speakers, frames), torch.float32),
                      ((self.max_streams,), torch.int64),
                      ((self.max_streams,), torch.bool))
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
        self.fade_rounds = 0
        self.variant_rounds: Counter = Counter()

    def _mac_bank(self, params: upols.ConvParams) -> torch.Tensor:
        if self._paged:
            return upols.paged_bank(params, self.blocks_per_step,
                                    self._k_padded)
        return upols.single_block_bank(params, self._k_padded)

    def _rebuild_conv_params(self) -> None:
        """The active bank from the renderer's params zero-padded to the
        CARRY's partition count, with everything derived from it: the MAC
        operand, the synthesis weights, the folded synthesis (rebuilt at
        the next round) and the lane-debt modulus."""
        self._conv_params = upols.ConvParams(*(
            t.to(self.device) for t in upols.pad_conv_params(
                self.renderer.conv_params, self._bank_partitions)))
        self._bank = self._mac_bank(self._conv_params)
        self._synth = upols.project_weights(self._conv_params, self._k_padded)
        self._folded = (None, None)  # (eq params, synthesis with them folded)
        # One full rotation of a lane's carry is the identity: n_pages
        # rounds for the paged line, P2 cursor advances for the ring.
        M = self.blocks_per_step
        self._lane_cycle = self._bank_partitions // M

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
        """A zeroed carry at the carry's partition count."""
        S, P = self.renderer.num_speakers, self._bank_partitions
        if self._paged:
            conv = upols.make_conv_state_paged(
                self.max_streams, S, P, self.block_size, self.blocks_per_step,
                self.device)
        else:
            conv = upols.make_conv_state(self.max_streams, S, P,
                                         self.block_size, self.device)
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
                    self._conv_params, self._k_padded,
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
        # fresh stream joins with no alignment debt, and it owes no fade: a
        # fresh history hears the active bank directly.
        self._reset_pending[stream] = True
        self._debt[stream] = 0
        self._xfade_pending[stream] = False
        return stream

    def detach(self, stream: int) -> None:
        if self._attached.pop(stream, None):
            self._attached_mask[stream] = False
            self._xfade_pending[stream] = False
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

    @torch.inference_mode()
    def set_renderer(self, renderer: RendererState,
                     group: Optional[int] = None,
                     crossfade: bool = True) -> bool:
        """HRIR hot-swap. Returns True when the swap crossfaded (history
        kept), False when it reset.

        With crossfade=True a bank that fits the carry (partition count at
        most the carry's; a shorter bank is zero-padded onto it) keeps
        every lane's conv history, and each attached lane's next rendered
        round runs the dual bank, blending old -> new per sample over
        min(20 ms, one round) before the EQ. Paused lanes fade when they
        rejoin; lanes attached after the swap hear the new bank directly.
        A second swap while fades are pending is newest-wins: pending lanes
        re-arm toward the newest bank from the newer old half, as the JAX
        pool does (a lane that never rendered the first fade starts its
        blend from the intermediate bank, not from what it last played:
        one round of cosmetic difference, not a state error, since the
        carry is bank-independent). Alignment debt is untouched.

        A longer bank, or crossfade=False, resets the history and
        reallocates the carry when its partition count changes (a zeroed
        lane is rotation-invariant, so no lane owes alignment work).
        `group` other than None or 0 needs profile groups, not ported."""
        if group not in (None, 0):
            raise NotImplementedError(
                f"set_renderer(group={group}) needs {_ROADMAP_GROUPS}, which "
                f"is not ported yet")
        self._check_renderer_lookahead(renderer)
        if renderer.num_speakers != self.renderer.num_speakers:
            raise ValueError("renderer speaker count must match the pool's "
                             "input layout")
        # Deferred attach zeroing lands first: a pending lane's garbage must
        # never be kept by a fade or carried into a reallocated carry.
        self._flush_attach_resets()
        self.renderer = renderer
        if crossfade and renderer.partition_count <= self._bank_partitions:
            old_active = self._conv_params
            self._rebuild_conv_params()  # padded onto the unchanged carry
            self._xfade_params = upols.xfade_conv_params(old_active,
                                                         self._conv_params)
            self._xfade_operands = ChainOperands(
                self._mac_bank(self._xfade_params), self._synth, None)
            self._xfade_pending[:] = self._attached_mask
            if self._xfade_ramp is None:
                L = self.step_frames
                fade = self.config.transition_length(self.sample_rate)
                self._xfade_ramp = torch.from_numpy(
                    upols.xfade_ramp(min(fade, L), L)).to(self.device)
            return True
        # Reset: fresh history, the carry re-sized to the new bank.
        same_shape = renderer.partition_count == self._bank_partitions
        self._bank_partitions = renderer.partition_count
        self._clear_xfade()
        self._rebuild_conv_params()
        if same_shape:
            reset = upols.conv_reset_paged if self._paged else upols.conv_reset
            conv = reset(self._state.conv)
        else:
            conv = self._fresh_state().conv
        self._state = PoolState(conv=conv, eq=self._state.eq)
        self._debt[:] = 0
        return False

    def _clear_xfade(self) -> None:
        """Drop the in-flight hot-swap fade."""
        self._xfade_params = self._xfade_operands = None
        self._xfade_pending[:] = False

    # --- checkpoint / resume -----------------------------------------------

    @torch.inference_mode()
    def snapshot(self, materialize: bool = True) -> dict:
        """A checkpoint of every lane's carry and of the host state that
        interprets it: alignment debt, the attached lanes, the EQ
        crossfade machine. Ring contents (undelivered audio) are transient
        and not captured. `restore` on a pool of the same construction
        resumes bit for bit.

        materialize=True gives numpy leaves (the carry fetched to the
        host); materialize=False keeps device copies (one pass on the card,
        no host readback), for a caller that must not hold serving while
        gigabytes come back: copy under its lock, fetch outside it."""
        self._flush_attach_resets()  # a checkpoint never carries garbage
        return {
            "state": _map_carry(_to_host if materialize else torch.clone,
                                self._state),
            "debt": self._debt.copy(),
            "attached": sorted(self._attached),
            "eq_runtime": self.eq_runtime.snapshot(),
            "eq_enabled": self._eq_enabled,
            "groups": 1,
        }

    def state_like(self, max_streams: int) -> dict:
        """The carry (and debt) a snapshot of this pool's construction at
        `max_streams` lanes holds, as tensors on the "meta" device, which
        allocate nothing: what such a snapshot is checked against before
        restore(..., resize=True) maps its lanes in."""
        lanes = int(max_streams)

        def like(t: torch.Tensor, lane_axis: int) -> torch.Tensor:
            shape = list(t.shape)
            shape[lane_axis] = lanes
            return torch.empty(shape, dtype=t.dtype, device="meta")

        conv, eq = self._state
        if self._paged:
            conv = upols.PagedConvState(pages=tuple(like(p, -1)
                                                    for p in conv.pages))
        else:
            conv = upols.ConvState(fdl=like(conv.fdl, -1),
                                   write_pos=np.int32(conv.write_pos))
        return {
            "state": PoolState(conv, eq_block.EqState(*(like(t, 0)
                                                        for t in eq))),
            "debt": torch.empty((lanes,), dtype=torch.int64, device="meta"),
        }

    def _resize_snapshot_lanes(self, snap: dict, state: PoolState,
                               debt: np.ndarray):
        """Map a snapshot written at another lane count onto this pool:
        attached lanes compact to the head of the lane space in ascending
        old-id order (one gather per carry tensor); free lanes gather old
        lane 0 as finite filler and are reset before any use. Returns
        (state', debt', attached', lane_map {old id: new id})."""
        old_max = int(debt.shape[0])
        attached_old = sorted(int(s) for s in snap["attached"])
        if any(not (0 <= s < old_max) for s in attached_old):
            raise ValueError(
                f"snapshot attached streams out of range for its own lane "
                f"count {old_max}: {attached_old}")
        if len(attached_old) > self.max_streams:
            raise ValueError(
                f"cannot resize: snapshot group 0 has {len(attached_old)} "
                f"attached lanes, resized pool fits {self.max_streams} per "
                f"group: detach streams or size the pool to hold them")
        idx = np.zeros(self.max_streams, np.int64)
        idx[:len(attached_old)] = attached_old
        lanes = torch.from_numpy(idx).to(self.device)
        lane_map = {s: r for r, s in enumerate(attached_old)}
        conv, eq = state
        if hasattr(conv, "pages"):
            conv = upols.PagedConvState(pages=tuple(
                p.index_select(-1, lanes) for p in conv.pages))
        else:
            conv = upols.ConvState(fdl=conv.fdl.index_select(-1, lanes),
                                   write_pos=conv.write_pos)
        eq = eq_block.EqState(*(t.index_select(0, lanes) for t in eq))
        new_debt = np.zeros(self.max_streams, np.int64)
        new_debt[:len(attached_old)] = debt[attached_old]
        return (PoolState(conv, eq), new_debt, sorted(lane_map.values()),
                lane_map)

    @torch.inference_mode()
    def restore(self, snap: dict, resize: bool = False) -> Optional[dict]:
        """Load a `snapshot()` (this pool's, or the JAX pool's through
        interop.pool_snapshot_from_numpy). With resize=True the snapshot may
        come from a pool of another max_streams (the same renderer shape
        and tier): attached lanes keep their exact history and compact
        into this pool's lanes in ascending old-id order, and the
        {old id: new id} map is returned for remapping per-lane bookkeeping
        outside the pool; it raises if the attached lanes do not fit.
        Returns None when no remap happened.

        Everything is checked before anything changes, so a bad snapshot
        leaves the pool as it was."""
        groups = int(snap.get("groups", 1))
        if groups != 1:
            raise ValueError(f"snapshot has {groups} profile groups, pool "
                             f"has 1")
        want = [(n, tuple(t.shape), t.dtype)
                for n, t in _carry_leaves(self._state)]
        try:
            state = _map_carry(self._restored_leaf, snap["state"])
        except (AttributeError, TypeError) as err:
            raise ValueError(f"snapshot state is not a pool carry: {err}") from err
        debt = np.asarray(snap["debt"], np.int64)
        lane_map = None
        if resize and debt.shape[0] != self.max_streams:
            state, debt, attached, lane_map = self._resize_snapshot_lanes(
                snap, state, debt)
        else:
            attached = sorted(int(s) for s in snap["attached"])
        got = [(n, tuple(t.shape), t.dtype) for n, t in _carry_leaves(state)]
        if got != want:
            raise ValueError(f"snapshot shape/dtype mismatch: {got} vs pool "
                             f"{want}")
        if not self._paged and not 0 <= int(state.conv.write_pos) < (
                self._bank_partitions):
            raise ValueError(f"snapshot ring cursor {state.conv.write_pos} "
                             f"out of range for {self._bank_partitions} "
                             f"partitions")
        if debt.shape != (self.max_streams,):
            raise ValueError(f"snapshot debt length {debt.shape} vs pool "
                             f"({self.max_streams},)")
        if any(not (0 <= s < self.max_streams) for s in attached):
            raise ValueError(f"snapshot attached streams out of range for "
                             f"max_streams={self.max_streams}: {attached}")
        # The EQ machine is rebuilt on a scratch runtime first: a definition
        # that does not design must fail here, before the pool changes.
        EqualizerRuntime(self.sample_rate, self.block_size,
                         self.config.eq_state_dim, self.config,
                         device=self.device).restore(snap["eq_runtime"])

        self._state = state
        self._debt[:] = debt
        # The restored carry is authoritative: attach resets pending against
        # the previous state must not zero restored rows. After a resize the
        # free lanes hold gather filler, so they ARE pending.
        self._reset_pending[:] = False
        # A fade in flight is not checkpointed: the carry is
        # bank-independent, so pending lanes jump to the active bank.
        self._clear_xfade()
        self._attached = {s: True for s in attached}
        self._attached_mask[:] = False
        self._attached_mask[attached] = True
        if lane_map is not None:
            self._reset_pending[:] = ~self._attached_mask
        self._free = [s for s in range(self.max_streams - 1, -1, -1)
                      if s not in self._attached]
        self._pending_out.clear()
        for s in range(self.max_streams):
            self.assembler.reset_stream(s)
            self._out.reset_stream(s)
        self.eq_runtime.restore(snap["eq_runtime"])
        self._eq_enabled = bool(snap.get("eq_enabled", self._eq_enabled))
        return lane_map

    def _restored_leaf(self, a) -> torch.Tensor:
        """A snapshot leaf as a new contiguous tensor on the pool's device:
        the pool writes its carry in place, so a snapshot can be restored
        again."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, copy=True).contiguous()
        return torch.tensor(np.asarray(a), device=self.device)

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
        throwaway state, and one lane roll. include_hotswap=True also runs
        each variant of a hot-swap round, on a self-crossfade of the active
        bank (the dual bank's shapes are those of any later same-carry
        swap). The pool's own state, cursor, debt, fades and EQ machine are
        untouched."""
        if self.device.type == "cuda":
            mac_kmajor.build()
        p = self.eq_runtime.active.params
        B, S = self.max_streams, self.renderer.num_speakers
        shape = ((B, S, self.blocks_per_step, self.block_size) if self._paged
                 else (B, S, self.block_size))
        blocks = torch.zeros(shape, device=self.device)
        idx = torch.arange(B, device=self.device)
        variants = PAGED_VARIANTS if self._paged else RING_VARIANTS
        rounds = [(self._conv_params, self._operands(p), None, None)]
        if include_hotswap:
            dual = upols.xfade_conv_params(self._conv_params, self._conv_params)
            rounds.append((dual, ChainOperands(self._mac_bank(dual),
                                               self._synth, None),
                           torch.zeros(self.step_frames, device=self.device),
                           torch.zeros(B, dtype=torch.bool,
                                       device=self.device)))
        for crossfading in ((False, True) if self._eq_enabled else (False,)):
            for variant in variants:
                for params, operands, ramp, mask in rounds:
                    pool_step_body(params, p, p, self._fresh_state(), blocks,
                                   idx, self.eq_runtime.transition_length,
                                   self._eq_enabled, crossfading, variant,
                                   operands, ramp, mask)
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
                               for t in up.tensors[:2])
                # A hot-swap round if any harvested lane still owes its
                # fade: the dual bank runs, pending lanes blend old -> new
                # and the others take the new half. The mask goes up as a
                # staged copy of _xfade_pending, which changes right below.
                fading = (self._xfade_params is not None
                          and self._xfade_pending[indices].any())
                conv_params, ramp, mask = self._conv_params, None, None
                if fading:
                    conv_params, ramp = self._xfade_params, self._xfade_ramp
                    up.arrays[2][:] = self._xfade_pending
                    mask = up.tensors[2].to(self.device, non_blocking=True)
                up.record()
                if M > 1:
                    # [k, S, M*T] -> [k, S, M, T]: ring pops are frame-major
                    # per channel, so the view is free.
                    blocks = blocks.view(k, S, M, self.block_size)

                eq_state, p_from, p_to, crossfading = self._begin_eq_round(
                    self._state.eq)
                variant = self._variant(indices)
                operands = (self._xfade_operands if fading
                            else self._operands(p_to))
                state, y_rows = pool_step_body(
                    conv_params, p_from, p_to,
                    PoolState(self._state.conv, eq_state), blocks, idx,
                    self.eq_runtime.transition_length, self._eq_enabled,
                    crossfading, variant, operands, ramp, mask)
                self._state = state
                if fading:
                    self.fade_rounds += 1
                    self._xfade_pending[indices] = False
                    if not (self._xfade_pending & self._attached_mask).any():
                        self._clear_xfade()  # every lane has faded
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
            self._clear_xfade()  # a zeroed history has nothing to blend
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
            "hotswap_fading": int((self._xfade_pending & attached).sum()),
            "fade_rounds": self.fade_rounds,
        }
