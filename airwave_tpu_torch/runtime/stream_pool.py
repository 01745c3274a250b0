"""StreamPool: the multi-stream serving engine (PyTorch).

Port of airwave_tpu/runtime/stream_pool.py: ragged per-stream ingest
through the native C++ assembler, dense masked device steps, per-stream
drain with the reference's underflow contract. The per-stream lifecycle is
attach/push/pump/pull/detach. A stream advances only when a full step of
its own input exists, and the shared-cursor ring step preserves idle
lanes' carries exactly (masked slot write, then a per-lane roll that
repays the alignment debt when the lane rejoins).

Two serving tiers:
  - blocks_per_step=1 (default): zero added latency, the shared-cursor
    ring step (variants "ring", "ring_all", "ring_id").
  - blocks_per_step=M: the throughput tier. Each round renders M blocks
    per lane on the bake path's paged delay line with the EQ folded into
    the synthesis DFT; idle lanes recycle their oldest page and are
    re-aligned page-granularly at rejoin ("paged", "paged_all",
    "paged_id").

Profile groups (multi-tenant serving): `StreamPool(profiles=[PoolProfile(
renderer, eq), ...])` serves G (HRIR, EQ) profiles from one pool in one
round. The lane space splits into G contiguous equal segments (attach
takes `group=`), and each group carries its own lane state: the carry is a
G-tuple of per-group ConvState/EqState (a one-profile pool keeps the bare
ones, as the JAX pool does, so snapshots and serve files stay
interchangeable). A round stages the harvest once at full width, then runs
each group's ring or paged chain on its leading-axis slice, so every
kernel launch reads its own group's contiguous delay line at the group's
own lane and partition counts. Profiles share speaker count and block
size; partition counts may differ. set_equalizer(group=g) crossfades only
that group's lanes, set_renderer(group=g) swaps only that group's bank.

EQ retargets (set_equalizer) run the 20 ms crossfade through the port's
EqualizerRuntime, with the reference's semantics: lanes rendering during
the ramp crossfade per sample, a lane idle across the whole ramp hears the
new target when it resumes, and a lane attaching mid-ramp hears the target
directly.

HRIR hot-swaps (set_renderer) keep every lane's conv history: the delay
line holds bank-independent input spectra, so each lane's next rendered
round runs a fade bank (upols.xfade_conv_params) and blends old -> new per
sample before the EQ. Each lane fades from the bank it last played: after
a second swap while fades are pending, the fade bank holds every such
bank (original, intermediate, newest) and each lane picks its own old
half, which is the ideal time-varying filter. On a grouped pool a fade
round runs every group on a fade bank: groups not swapping run their
cached self-crossfade, so one round shape serves any pattern of
concurrent swaps. The carry's partition count is tracked apart from the
renderer's: a shorter bank is zero-padded onto the carry, and the
lane-debt modulus stays the carry's. `snapshot` and `restore` checkpoint
the carry with the host state that interprets it (debt, attached lanes,
the EQ machines); `restore(..., resize=True)` maps a snapshot of another
lane count onto this pool, group by group.

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
  - A second swap while a lane still owes the first fade blends that lane
    from the bank it last played; the JAX pool blends it from the
    intermediate bank, a step at that round boundary.
  - Self-crossfade banks of groups that are not swapping are built once
    per bank, not in every fade round.

Device meshes (`mesh=`, parallel/mesh.Mesh, 1-D "streams"): the lane
space splits into stream shards as the JAX pool's NamedSharding does, each
group's lanes independently, so unit (group g, shard s) holds the group's
lanes [s*q/n, (s+1)*q/n) of its q on shard s's device (devices may repeat:
virtual shards). A round harvests each shard's rows into its slice of the
pinned upload, runs each shard's chain (_chain, or _pool_round_grouped
over its G units) on its device and, on a card, its own CUDA stream,
downloads into its slice of the pinned download, and records one event
per shard. Params and banks are copied once per distinct device. No
tensor crosses shards in a round: every unit of a group steps every round
(the JAX pool's one SPMD step), so a group's ring cursor and the lanes'
debt stay shared. Snapshots gather each group's carry in lane order, so
a sharded pool's snapshot is the unsharded pool's format and restores into
either package's pool, and the other way round.
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
from airwave_tpu_torch.parallel.mesh import (STREAMS, Replicas, ShardStreams,
                                             cat_lanes, lane_axes,
                                             process_index, take_lanes)

RING_VARIANTS = ("ring", "ring_all", "ring_id")
PAGED_VARIANTS = ("paged", "paged_all", "paged_id")
EARS = 2  # the pool renders binaural stereo


class PoolState(NamedTuple):
    """The pool carry: a ConvState (ring) or PagedConvState (paged) and an
    EqState, or on a grouped pool a G-tuple of each."""

    conv: "upols.ConvState | upols.PagedConvState | tuple"
    eq: "eq_block.EqState | tuple"


class PoolProfile(NamedTuple):
    """One tenant profile of a grouped pool: a prepared renderer and an
    optional EQ preset (None = unity). A pool's profiles share speaker
    count and block size (and lookahead on the paged tier); partition
    counts may differ."""

    renderer: RendererState
    eq_definition: Optional[EqualizerDefinition] = None


def _grouped(tree) -> bool:
    """True for a grouped carry or params (a plain tuple of per-group
    NamedTuples; a NamedTuple is one group's)."""
    return type(tree) is tuple


def _scatter_rows(blocks: torch.Tensor, idx: torch.Tensor,
                  batch: int) -> torch.Tensor:
    """The dense [batch, ...] input with the k harvested rows at idx (a
    distinct, in-range index per row) and zeros elsewhere."""
    x = blocks.new_zeros((batch,) + tuple(blocks.shape[1:]))
    return x.index_copy_(0, idx, blocks)


def _lane_mask(idx: torch.Tensor, batch: int) -> torch.Tensor:
    return torch.zeros(batch, dtype=torch.bool,
                       device=idx.device).index_fill_(0, idx, True)


def _conv_lanes(conv) -> int:
    return (conv.pages[0] if hasattr(conv, "pages") else conv.fdl).shape[-1]


def _map_conv(fn, conv):
    """One conv carry with fn applied to each tensor leaf (duck-typed, so a
    carry written by the JAX pool, with numpy leaves, maps too). The ring
    cursor stays a host integer, kept as an np.int32 as the JAX carry
    holds it."""
    if hasattr(conv, "pages"):
        return upols.PagedConvState(pages=tuple(fn(p) for p in conv.pages))
    return upols.ConvState(fdl=fn(conv.fdl),
                           write_pos=np.int32(np.asarray(conv.write_pos)))


def _map_eq(fn, eq) -> eq_block.EqState:
    return eq_block.EqState(s_from=fn(eq.s_from), s_to=fn(eq.s_to),
                            counter=fn(eq.counter))


def _map_carry(fn, state) -> PoolState:
    """The pool carry, grouped or not, with fn applied to each leaf."""
    if _grouped(state.conv):
        return PoolState(tuple(_map_conv(fn, c) for c in state.conv),
                         tuple(_map_eq(fn, e) for e in state.eq))
    return PoolState(_map_conv(fn, state.conv), _map_eq(fn, state.eq))


def _carry_leaves(state: PoolState) -> list:
    """(name, tensor) for each tensor of a pool carry, in a fixed order."""
    if _grouped(state.conv):
        return [(f"group {g} {name}", t)
                for g, (c, e) in enumerate(zip(state.conv, state.eq))
                for name, t in _carry_leaves(PoolState(c, e))]
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


def pool_step_body(conv_params, eq_from, eq_to, state: PoolState,
                   blocks: torch.Tensor, idx: torch.Tensor,
                   transition_length: int, eq_enabled: bool,
                   eq_crossfading: bool, variant: str = "ring",
                   operands=None,
                   xfade_ramp: "torch.Tensor | None" = None,
                   xfade_mask: "torch.Tensor | None" = None,
                   xfade_src: "torch.Tensor | None" = None):
    """One pool round: scatter the k harvested rows into the dense batch,
    step the (masked) chain, gather the harvested rows back.

    blocks [k, S, T] (ring) or [k, S, M, T] (paged), idx [k] int64 distinct
    lanes -> (state', y_rows [k, E, T] or [k, M, E, T]).

    "ring" masks the lanes that were not harvested (their slot and EQ state
    are preserved). "ring_all" runs when every attached lane is harvested:
    free lanes' garbage is harmless (attach resets a lane), so the masking
    is skipped. "ring_id" additionally has idx == arange(B): the rows ARE
    the dense batch, so the scatter and gather are skipped too. The paged
    variants are the same three for the M-block tier.

    On a grouped pool conv_params, eq_from, eq_to, operands and the
    state's conv and eq are G-tuples (_pool_round_grouped).

    `xfade_ramp` [round frames] with `xfade_mask` [B] bool runs a hot-swap
    round (StreamPool.set_renderer): conv_params is a fade bank
    (upols.xfade_conv_params, H halves of E ears, the NEW bank last) over
    the unchanged delay line, and masked lanes blend from their old half
    (`xfade_src` [B] int64, or half 0) to the new one per sample before the
    EQ; the other lanes take the pure new half.

    The ring step writes state.conv's delay line in place
    (upols.conv_step): the state passed in is consumed. `operands` are the
    bank-derived MAC and synthesis operands (built when not given)."""
    if _grouped(conv_params):
        return _pool_round_grouped(conv_params, eq_from, eq_to, state,
                                   blocks, idx, transition_length,
                                   eq_enabled, eq_crossfading, variant,
                                   operands, xfade_ramp, xfade_mask,
                                   xfade_src)
    paged = _check_variant(variant)
    B = _conv_lanes(state.conv)
    x, mask, identity = _stage(blocks, idx, B, variant)
    conv, eq, y = _chain(conv_params, eq_from, eq_to, state.conv, state.eq,
                         x, mask, paged, transition_length, eq_enabled,
                         eq_crossfading, operands, xfade_ramp, xfade_mask,
                         xfade_src)
    y_rows = y if identity else y.index_select(0, idx)
    return PoolState(conv, eq), y_rows


def _check_variant(variant: str) -> bool:
    """True for a paged variant; raises for an unknown one."""
    if variant not in RING_VARIANTS + PAGED_VARIANTS:
        raise ValueError(f"unknown pool step variant {variant!r}")
    return variant in PAGED_VARIANTS


def _stage(blocks: torch.Tensor, idx: torch.Tensor, B: int, variant: str):
    """(dense input x [B, ...], lane mask or None, identity) of a round."""
    identity = variant.endswith("_id")
    if identity and blocks.shape[0] != B:
        raise ValueError(f"{variant} needs all {B} lanes, got "
                         f"{blocks.shape[0]}")
    x = blocks if identity else _scatter_rows(blocks, idx, B)
    mask = _lane_mask(idx, B) if variant in ("ring", "paged") else None
    return x, mask, identity


def _chain(conv_params, eq_from, eq_to, conv_state, eq_state, x, mask, paged,
           transition_length, eq_enabled, eq_crossfading, operands=None,
           xfade_ramp=None, xfade_mask=None, xfade_src=None):
    """One group's chain on its dense input: x [B, S, T] (ring) or
    [B, S, M, T] (paged) -> (conv', eq', y [B, E, T] or [B, M, E, T]).

    The paged steady state (eq_crossfading=False) folds the EQ's FIR and
    state drive into the synthesis weights (eq_block.eq_folded_paged_round);
    during a ramp the plain synthesis runs and the M blocks go through
    eq_step in order. A hot-swap round (xfade_ramp given) takes the plain
    path too: the blended signal must drive the EQ, and the fold never
    materializes the spatial output. `mask` [B] preserves idle lanes (the
    ring's slot read-back, the paged line's recycled oldest page)."""
    bank = operands.bank if operands else None
    synth = operands.synth if operands else None
    if paged and eq_enabled and not eq_crossfading and xfade_ramp is None:
        conv_state, new_eq, y = eq_block.eq_folded_paged_round(
            conv_params, eq_to, conv_state, eq_state, x, bank,
            operands.synth_folded if operands else None, active_mask=mask)
    else:
        step = upols.conv_step_paged if paged else upols.conv_step
        conv_state, y = step(conv_params, conv_state, x, bank, synth,
                             active_mask=mask)
        if xfade_ramp is not None:
            y = upols.xfade_blend(y, xfade_ramp, xfade_mask, xfade_src,
                                  halves=conv_params.num_ears // EARS)
        new_eq = eq_state
        if eq_enabled and paged:
            outs = []
            for m in range(x.shape[2]):
                new_eq, ym = eq_block.eq_step(eq_from, eq_to, new_eq, y[:, m],
                                              transition_length,
                                              eq_crossfading)
                outs.append(ym)
            y = torch.stack(outs, dim=1)
        elif eq_enabled:
            new_eq, y = eq_block.eq_step(eq_from, eq_to, eq_state, y,
                                         transition_length, eq_crossfading)
    if eq_enabled:
        eq_state = new_eq if mask is None else _where_lanes(mask, new_eq,
                                                            eq_state)
    return conv_state, eq_state, y


def _pool_round_grouped(conv_params, eq_from, eq_to, state, blocks, idx,
                        transition_length, eq_enabled, eq_crossfading,
                        variant, operands=None, xfade_ramp=None,
                        xfade_mask=None, xfade_src=None):
    """One round of a profile-grouped pool: G independent chains, each on
    its own group's carry (lane b belongs to group b // (B/G)). The harvest
    is staged once at the full lane space (scatter and mask), then each
    group takes its leading-axis slice and runs the chain an ungrouped pool
    of its lane count runs, so its MAC launch reads the group's own
    contiguous delay line; the outputs are concatenated and the harvested
    rows gathered back once."""
    paged = _check_variant(variant)
    G = len(conv_params)
    Bg = _conv_lanes(state.conv[0])
    x, mask, identity = _stage(blocks, idx, G * Bg, variant)
    convs, eqs, outs = [], [], []
    for g in range(G):
        lanes = slice(g * Bg, (g + 1) * Bg)

        def part(t, lanes=lanes):
            return None if t is None else t[lanes]

        conv, eq, y = _chain(conv_params[g], eq_from[g], eq_to[g],
                             state.conv[g], state.eq[g], x[lanes],
                             part(mask), paged, transition_length,
                             eq_enabled, eq_crossfading,
                             operands[g] if operands else None, xfade_ramp,
                             part(xfade_mask), part(xfade_src))
        convs.append(conv)
        eqs.append(eq)
        outs.append(y)
    y = torch.cat(outs)
    y_rows = y if identity else y.index_select(0, idx)
    return PoolState(tuple(convs), tuple(eqs)), y_rows


class _HostSlot:
    """Host staging buffers for one round's upload or download: pinned on a
    card, so their copies run asynchronously, with a CUDA event per shard
    recorded behind the last copy of that shard's rows. wait() returns once
    every shard's copy has completed; on the CPU copies are synchronous and
    there are no events. `tensors` and their numpy views `arrays` follow
    `specs`, a sequence of (shape, dtype)."""

    def __init__(self, devices, *specs) -> None:
        pinned = any(d.type == "cuda" for d in devices)
        self.tensors = [torch.empty(shape, dtype=dtype, pin_memory=pinned)
                        for shape, dtype in specs]
        self.arrays = [t.numpy() for t in self.tensors]
        self.events = [torch.cuda.Event() if d.type == "cuda" else None
                       for d in devices]

    def record(self, shard: int = 0) -> None:
        """Record shard's event on the current stream (its own in a round)."""
        if self.events[shard] is not None:
            self.events[shard].record()

    def wait(self) -> None:
        for event in self.events:
            if event is not None:
                event.synchronize()


class _Bank:
    """One group's active bank on the device (the renderer's params padded
    to the carry's partition count) and the operands derived from it: the
    MAC operand, the synthesis weights, the folded synthesis of the last
    EQ target, and the self-crossfade fade bank, built when a fade round
    first needs it and kept until the bank changes."""

    def __init__(self, params: upols.ConvParams, mac: torch.Tensor,
                 synth: torch.Tensor) -> None:
        self.params, self.mac, self.synth = params, mac, synth
        self.folded = (None, None)  # (eq params, synthesis with them folded)
        self.self_fade: "tuple | None" = None  # (params, ChainOperands)


class _Fade:
    """A group's hot-swap fade in flight: the banks its pending lanes last
    played (`olds`, each lane's index in StreamPool._xfade_src) and the
    fade bank [olds..., new] with its operands."""

    def __init__(self, olds: list, params: upols.ConvParams,
                 operands: ChainOperands) -> None:
        self.olds, self.params, self.operands = olds, params, operands


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
        device: "torch.device | str | None" = None,
    ) -> None:
        """A pool of `max_streams` lanes on `device` (the card by default;
        pass device="cpu" for the CPU). The renderers' conv params are
        moved to the device.

        `mesh`: a 1-D parallel.mesh.Mesh with axis name "streams" whose
        devices this process holds (one pool per process). The lane state
        shards over it (module docstring); each group's lane count must
        divide by the mesh size. The pool's own device (EQ machines,
        active banks) is the mesh's first, and `device`, if given, must
        name it.

        `blocks_per_step=M > 1` is the throughput tier (module docstring):
        a lane advances only when M full blocks of its input exist, so
        output latency grows to up to M blocks. It needs renderers
        prepared with lookahead=M.

        `profiles`: a sequence of PoolProfile (or (renderer, eq) pairs),
        mutually exclusive with renderer/eq_definition, makes a grouped
        multi-tenant pool of len(profiles) groups; max_streams must divide
        by it."""
        if profiles is not None:
            if renderer is not None or eq_definition is not None:
                raise ValueError("pass either renderer/eq_definition or "
                                 "profiles, not both")
            profiles = [p if isinstance(p, PoolProfile) else PoolProfile(*p)
                        for p in profiles]
            if not profiles:
                raise ValueError("profiles must be non-empty")
        else:
            if renderer is None:
                raise TypeError("renderer is required (or pass profiles=)")
            profiles = [PoolProfile(renderer, eq_definition)]
        shard_devices = self._mesh_devices(mesh, device)
        self.mesh = mesh
        self.device = shard_devices[0]
        apply_precision_policy()
        self.max_streams = int(max_streams)
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.blocks_per_step = int(blocks_per_step)
        self.config = config
        if self.blocks_per_step < 1:
            raise ValueError(f"blocks_per_step must be >= 1, got "
                             f"{blocks_per_step}")
        self.groups = len(profiles)
        if self.max_streams % self.groups:
            raise ValueError(f"max_streams ({self.max_streams}) must divide "
                             f"by the profile-group count ({self.groups})")
        self.group_size = self.max_streams // self.groups
        if self.group_size % len(shard_devices):
            raise ValueError(
                f"per-group lane count ({self.group_size}) must divide by the "
                f"mesh size ({len(shard_devices)}): each group's lane state "
                f"shards independently")
        self._init_shards(shard_devices)
        self.renderers = [p.renderer for p in profiles]
        first = self.renderers[0]
        for g, r in enumerate(self.renderers):
            self._check_renderer_lookahead(r)
            if (r.num_speakers, r.block_size) != (first.num_speakers,
                                                  first.block_size):
                raise ValueError(
                    f"grouped profiles must share (speakers, block): group "
                    f"0 has ({first.num_speakers}, {first.block_size}), "
                    f"group {g} has ({r.num_speakers}, {r.block_size}); "
                    f"partition counts (HRIR lengths) may differ, each "
                    f"group carries its own delay line")
        self.renderer = first
        self._k_padded = upols.padded_bin_count(self.block_size)
        # Each group's carry partition count. After a crossfaded
        # shorter-HRIR swap the active bank is the renderer's zero-padded
        # onto the unchanged carry, so it may exceed the renderer's own.
        self._bank_partitions = [r.partition_count for r in self.renderers]
        self._rebuild_conv_params()
        # Hot-swap fades in flight ({group: _Fade}), and per lane whether
        # its next rendered round still owes its fade and from which old
        # half (an index into its group's _Fade.olds).
        self._fades: Dict[int, _Fade] = {}
        self._xfade_pending = np.zeros(self.max_streams, bool)
        self._xfade_src = np.zeros(self.max_streams, np.int64)
        self._xfade_ramp: Optional[torch.Tensor] = None

        M = self.blocks_per_step
        speakers = first.num_speakers
        # Rings hold at least two full steps so a lane can buffer the next
        # round while one is in flight.
        capacity = block_size * max(int(ring_blocks), 2 * M)
        self.assembler = RaggedAssembler(max_streams, speakers, block_size,
                                         capacity=capacity, impl="native")
        self._out = RaggedAssembler(max_streams, EARS, block_size,
                                    capacity=capacity, impl="native")
        self.eq_runtimes = [self._new_eq_runtime() for _ in profiles]
        self.eq_runtime = self.eq_runtimes[0]  # the one-profile pool's
        self._eq_enabled = any(p.eq_definition is not None for p in profiles)
        for rt, p in zip(self.eq_runtimes, profiles):
            if p.eq_definition is not None:
                rt.set_target(p.eq_definition)
        # Lanes attached since the last device reset: attach is host
        # bookkeeping, and the zeroing of fresh lanes' carry rows is one
        # masked device op per group at the next round
        # (_flush_attach_resets).
        self._reset_pending = np.zeros(self.max_streams, bool)
        self._fresh_carry()
        self._attached: Dict[int, bool] = {}
        self._attached_mask = np.zeros(self.max_streams, bool)
        q = self.group_size
        self._free_by_group = [list(range((g + 1) * q - 1, g * q - 1, -1))
                               for g in range(self.groups)]
        # debt[b] counts the cursor advances (ring) or rounds (paged) a
        # lane sat out since it last stepped; a harvested lane with debt
        # not a multiple of its group's cycle is rolled into alignment.
        self._debt = np.zeros(self.max_streams, np.int64)
        # Rendered blocks whose output ring filled between the harvest-time
        # space check and delivery (an unlocked concurrent pull) stash here
        # in order and re-flush on pull. Serialized use never fills it.
        self._pending_out: Dict[int, deque] = {}
        frames = self.step_frames
        # Each upload slot: the harvested rows, their shard-local lanes, and
        # a fade round's lane mask and old halves in shard order (staged
        # copies: the host updates _xfade_pending right after the round is
        # queued). Shard s's rows and lanes follow shard s-1's.
        self._uploads = [
            _HostSlot(shard_devices,
                      ((self.max_streams, speakers, frames), torch.float32),
                      ((self.max_streams,), torch.int64),
                      ((self.max_streams,), torch.bool),
                      ((self.max_streams,), torch.int64))
            for _ in range(2)]
        self._downloads = [
            _HostSlot(shard_devices,
                      ((self.max_streams, EARS, frames), torch.float32))
            for _ in range(2)]
        self._turn = 0
        self.rounds = 0
        self.blocks_rendered = 0
        self.render_errors = 0
        self.debt_rolls = 0
        self.fade_rounds = 0
        self.variant_rounds: Counter = Counter()

    @staticmethod
    def _mesh_devices(mesh, device) -> list:
        """The shard devices: the mesh's (after the JAX pool's checks), or
        the one `device` (the card by default)."""
        if mesh is None:
            return [resolve_device(DEFAULT_DEVICE if device is None
                                   else device)]
        if tuple(mesh.axis_names) != (STREAMS,):
            raise ValueError("pool mesh must be 1-D with axis name 'streams'")
        if (np.asarray(mesh.process_index) != process_index()).any():
            raise ValueError("a pool's mesh must hold this process's devices "
                             "only: serve one pool per process")
        devices = [resolve_device(d) for d in mesh.devices.ravel()]
        if device is not None and resolve_device(device) != devices[0]:
            raise ValueError(f"device {device} is not the mesh's first device "
                             f"{devices[0]}")
        return devices

    def _init_shards(self, devices: list) -> None:
        """Lane layout of the stream shards. Unit u = g*n + s (group g,
        shard s) holds lanes [u*U, (u+1)*U), U = q/n; shard s runs its G
        units as a grouped pool of G*U local lanes, unit (g, s)'s lanes at
        [g*U, (g+1)*U). `_shard_order` lists the lanes shard by shard in
        that local order; `_local_lane` and `_shard_of_lane` invert it."""
        n = len(devices)
        self.shard_count = n
        self._shards = ShardStreams(devices, own_streams=n > 1)
        self._replicas = Replicas()
        self._unit_lanes = U = self.group_size // n
        unit = np.arange(self.max_streams) // U
        self._shard_of_lane = unit % n
        self._shard_order = np.argsort(self._shard_of_lane, kind="stable")
        local = self.groups * U
        self._local_lane = np.empty(self.max_streams, np.int64)
        self._local_lane[self._shard_order] = np.arange(self.max_streams) % local

    def _unit_device(self, u: int) -> torch.device:
        return self._shards.devices[u % self.shard_count]

    def _new_eq_runtime(self) -> EqualizerRuntime:
        return EqualizerRuntime(self.sample_rate, self.block_size,
                                self.config.eq_state_dim, self.config,
                                device=self.device)

    # --- banks -------------------------------------------------------------

    def _pack(self, items):
        """Per-group items as the step takes them: the one item of a
        one-profile pool, a G-tuple on a grouped pool."""
        items = tuple(items)
        return items[0] if self.groups == 1 else items

    def _mac_bank(self, params: upols.ConvParams) -> torch.Tensor:
        if self._paged:
            return upols.paged_bank(params, self.blocks_per_step,
                                    self._k_padded)
        return upols.single_block_bank(params, self._k_padded)

    def _make_bank(self, g: int) -> _Bank:
        params = upols.ConvParams(*(
            t.to(self.device) for t in upols.pad_conv_params(
                self.renderers[g].conv_params, self._bank_partitions[g])))
        return _Bank(params, self._mac_bank(params),
                     upols.project_weights(params, self._k_padded))

    def _rebuild_conv_params(self, group: Optional[int] = None) -> None:
        """Rebuild the active bank of `group` (or of every group) from its
        renderer's params zero-padded to the CARRY's partition count, with
        everything derived from it (a new _Bank, so its cached
        self-crossfade goes too), and the per-lane debt modulus: one full
        rotation of a lane's carry is the identity, n_pages rounds for the
        paged line, P2 cursor advances for the ring."""
        if group is None:
            self._banks = [self._make_bank(g) for g in range(self.groups)]
        else:
            self._banks[group] = self._make_bank(group)
        q, M = self.group_size, self.blocks_per_step
        self._lane_cycles = np.repeat(
            np.asarray(self._bank_partitions, np.int64) // M, q)

    @property
    def _conv_params(self):
        """The active banks: one ConvParams, or a G-tuple on a grouped
        pool."""
        return self._pack(b.params for b in self._banks)

    @property
    def _xfade_params(self):
        """The fade banks in flight: None when no fade is pending; the one
        ConvParams of a one-profile pool, {group: ConvParams} on a grouped
        pool."""
        if not self._fades:
            return None
        if self.groups == 1:
            return self._fades[0].params
        return {g: f.params for g, f in self._fades.items()}

    @property
    def _lane_cycle(self) -> int:
        """Group 0's debt modulus (every lane's on a one-profile pool)."""
        return int(self._lane_cycles[0])

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

    # --- the carry -----------------------------------------------------------

    @property
    def _state(self) -> PoolState:
        """The carry: bare ConvState/EqState on a one-profile pool, G-tuples
        of them on a grouped pool (the JAX pool's structure). On a sharded
        pool each group's carry gathered in lane order onto the pool's
        device (a copy); assigning it splits it over the shards. An
        unsharded pool's carry is read and assigned as it lies, so neither
        direction copies the whole carry."""
        if self.shard_count == 1:
            return self._shard_state(0)
        return self._gathered(self.device)

    @_state.setter
    def _state(self, state: PoolState) -> None:
        convs = state.conv if _grouped(state.conv) else (state.conv,)
        eqs = state.eq if _grouped(state.eq) else (state.eq,)
        n, U = self.shard_count, self._unit_lanes
        if n == 1:
            self._conv, self._eq = list(convs), list(eqs)
            return
        self._conv, self._eq = [], []
        for conv, eq in zip(convs, eqs):
            for s, dev in enumerate(self._shards.devices):
                self._conv.append(take_lanes(conv, lane_axes(conv), s * U, U,
                                             dev))
                self._eq.append(take_lanes(eq, lane_axes(eq), s * U, U, dev))

    def _units(self, shard: int) -> range:
        """The units (one per group) of a shard, in group order."""
        return range(shard, self.groups * self.shard_count, self.shard_count)

    def _shard_state(self, shard: int) -> PoolState:
        """Shard `shard`'s carry as its round takes it (the whole carry of
        an unsharded pool)."""
        units = self._units(shard)
        return PoolState(self._pack(self._conv[u] for u in units),
                         self._pack(self._eq[u] for u in units))

    def _gathered(self, device) -> PoolState:
        """Each group's carry, its shards concatenated in lane order, as
        new tensors on `device`."""
        n = self.shard_count
        convs, eqs = [], []
        for g in range(self.groups):
            units = range(g * n, (g + 1) * n)
            for out, parts in ((convs, self._conv), (eqs, self._eq)):
                pieces = [parts[u] for u in units]
                out.append(cat_lanes(pieces, lane_axes(pieces[0]), device))
        return PoolState(self._pack(convs), self._pack(eqs))

    @torch.inference_mode()
    def _fresh_unit_conv(self, u: int):
        """A zeroed conv carry for one unit's lanes at its group's carry
        partition count, on its shard's device."""
        g = u // self.shard_count
        S, P = self.renderer.num_speakers, self._bank_partitions[g]
        dev, U = self._unit_device(u), self._unit_lanes
        if self._paged:
            return upols.make_conv_state_paged(
                U, S, P, self.block_size, self.blocks_per_step, dev)
        return upols.make_conv_state(U, S, P, self.block_size, dev)

    def _fresh_unit_eq(self, u: int) -> eq_block.EqState:
        return eq_block.make_eq_state(self._unit_lanes, EARS,
                                      self.config.eq_state_dim,
                                      self._unit_device(u))

    @torch.inference_mode()
    def _fresh_carry(self) -> None:
        """Zero every unit's carry."""
        units = range(self.groups * self.shard_count)
        self._conv = [self._fresh_unit_conv(u) for u in units]
        self._eq = [self._fresh_unit_eq(u) for u in units]

    @torch.inference_mode()
    def _fresh_state(self, shard: int = 0) -> PoolState:
        """A zeroed carry of one shard at each group's partition count (the
        whole carry of an unsharded pool)."""
        units = self._units(shard)
        return PoolState(self._pack(self._fresh_unit_conv(u) for u in units),
                         self._pack(self._fresh_unit_eq(u) for u in units))

    def _operands(self, eq_to: eq_block.EqParams,
                  group: int = 0) -> ChainOperands:
        """A group's bank-derived operands for a steady round; the paged
        tier's folded synthesis depends on the group's EQ target and is
        rebuilt when it changes."""
        bank = self._banks[group]
        synth_folded = None
        if self._paged and self._eq_enabled:
            params, synth_folded = bank.folded
            if params is not eq_to:
                synth_folded = upols.project_weights(
                    bank.params, self._k_padded, eq_block.fold_post(eq_to))
                bank.folded = (eq_to, synth_folded)
        return ChainOperands(bank.mac, bank.synth, synth_folded)

    def _self_fade(self, group: int) -> tuple:
        """(params, operands) of the group's self-crossfade, the fade bank
        of a group that is not swapping in a grouped fade round (its output
        is its active bank's for any mask), built once per bank."""
        bank = self._banks[group]
        if bank.self_fade is None:
            params = upols.xfade_conv_params(bank.params, bank.params)
            bank.self_fade = (params, ChainOperands(
                self._mac_bank(params), bank.synth, None))
        return bank.self_fade

    # --- profile groups ------------------------------------------------------

    def group_of(self, stream: int) -> int:
        """Profile group owning a lane (contiguous equal segments; lanes
        past the pool map past the last group)."""
        return int(stream) // self.group_size

    def _segment(self, group: int) -> slice:
        return slice(group * self.group_size, (group + 1) * self.group_size)

    @property
    def _free(self) -> list:
        """Every free lane (leak checks, diagnostics)."""
        return [s for free in self._free_by_group for s in free]

    def _check_group(self, group: Optional[int]) -> None:
        if group is not None and not 0 <= group < self.groups:
            raise ValueError(f"group {group} out of range for {self.groups} "
                             f"profiles")

    # --- stream lifecycle --------------------------------------------------

    def attach(self, group: int = 0) -> int:
        """Claim a free lane in `group`'s segment."""
        self._check_group(group)
        free = self._free_by_group[group]
        if not free:
            raise RuntimeError("pool is full" if self.groups == 1
                               else f"profile group {group} is full")
        stream = free.pop()
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
            self._free_by_group[self.group_of(stream)].append(stream)
            self._pending_out.pop(stream, None)
            self.assembler.reset_stream(stream)
            self._out.reset_stream(stream)

    @torch.inference_mode()
    def _flush_attach_resets(self) -> None:
        """Zero the carry rows of every lane attached since the last flush,
        as one masked device op per unit (group, or group shard) that has
        such lanes."""
        if not self._reset_pending.any():
            return
        reset = upols.conv_reset_paged if self._paged else upols.conv_reset
        U = self._unit_lanes
        for u in range(len(self._conv)):
            seg = self._reset_pending[u * U:(u + 1) * U]
            if not seg.any():
                continue
            # COPY the mask: torch.from_numpy aliases the numpy buffer,
            # which is cleared right below.
            m = torch.from_numpy(seg.copy()).to(self._unit_device(u))
            eq = eq_block.eq_reset(self._eq[u], m)
            # A fresh lane hears the ACTIVE target directly: idle its
            # counter so an in-flight ramp blends it at weight 1.0 on the
            # 'to' cascade.
            self._eq[u] = eq._replace(counter=eq.counter.masked_fill(
                m, eq_block.COUNTER_IDLE))
            self._conv[u] = reset(self._conv[u], m)
        self._reset_pending[:] = False

    # --- control -----------------------------------------------------------

    def set_equalizer(self, definition: Optional[EqualizerDefinition],
                      group: Optional[int] = None) -> None:
        """Retarget the EQ (the 20 ms crossfade runs in the next rounds) of
        `group`'s lanes, or of every group with group=None. `None` on an
        EQ-less pool stays a no-op; `None` on an active pool crossfades to
        unity and keeps the EQ in the step."""
        self._check_group(group)
        if definition is None and not self._eq_enabled:
            return
        targets = self.eq_runtimes if group is None else [
            self.eq_runtimes[group]]
        for rt in targets:
            rt.set_target(definition)
        self._eq_enabled = True

    def _swap_group(self, renderer: RendererState,
                    group: Optional[int]) -> int:
        """The group a set_renderer call swaps, after the JAX pool's
        checks."""
        first = self.renderers[0]
        if self.groups == 1:
            if group not in (None, 0):
                raise ValueError(f"group {group} out of range for a "
                                 f"single-profile pool")
            if renderer.num_speakers != first.num_speakers:
                raise ValueError("renderer speaker count must match the "
                                 "pool's input layout")
            return 0
        if group is None:
            raise ValueError("a grouped pool needs set_renderer(..., "
                             "group=g)")
        self._check_group(group)
        if (renderer.num_speakers, renderer.block_size) != (
                first.num_speakers, first.block_size):
            raise ValueError(f"grouped swap must keep the pool's (speakers, "
                             f"block) = ({first.num_speakers}, "
                             f"{first.block_size})")
        return group

    @torch.inference_mode()
    def set_renderer(self, renderer: RendererState,
                     group: Optional[int] = None,
                     crossfade: bool = True) -> bool:
        """HRIR hot-swap of `group`'s bank (required on a grouped pool;
        None or 0 on a one-profile pool). Returns True when the swap
        crossfaded (history kept), False when it reset.

        With crossfade=True a bank that fits the group's carry (partition
        count at most the carry's; a shorter bank is zero-padded onto it)
        keeps every lane's conv history, and each attached lane of the
        group fades old -> new per sample over min(20 ms, one round) before
        the EQ in its next rendered round. Paused lanes fade when they
        rejoin; lanes attached after the swap hear the new bank directly.
        Each lane fades from the bank it last played: a second swap while
        fades are pending keeps the pending lanes' old banks in the fade
        bank beside the one the other lanes play. Alignment debt is
        untouched.

        A longer bank, or crossfade=False, resets the group's history; its
        carry is zeroed in place, or reallocated when its partition count
        changes (a zeroed lane is rotation-invariant, so no lane owes
        alignment work)."""
        self._check_renderer_lookahead(renderer)
        g = self._swap_group(renderer, group)
        # Deferred attach zeroing lands first: a pending lane's garbage must
        # never be kept by a fade or carried into a reallocated carry.
        self._flush_attach_resets()
        self.renderers[g] = renderer
        if g == 0:
            self.renderer = renderer
        if crossfade and renderer.partition_count <= self._bank_partitions[g]:
            old_active = self._banks[g].params
            self._rebuild_conv_params(g)  # padded onto the unchanged carry
            self._arm_fade(g, old_active)
            if self._xfade_ramp is None:
                L = self.step_frames
                fade = self.config.transition_length(self.sample_rate)
                self._xfade_ramp = torch.from_numpy(
                    upols.xfade_ramp(min(fade, L), L)).to(self.device)
            return True
        # Reset: fresh history, the group's carry re-sized to the new bank.
        same_shape = renderer.partition_count == self._bank_partitions[g]
        self._bank_partitions[g] = renderer.partition_count
        self._clear_xfade(g)
        self._rebuild_conv_params(g)
        reset = upols.conv_reset_paged if self._paged else upols.conv_reset
        for u in range(g * self.shard_count, (g + 1) * self.shard_count):
            self._conv[u] = (reset(self._conv[u]) if same_shape
                             else self._fresh_unit_conv(u))
        self._debt[self._segment(g)] = 0
        return False

    def _arm_fade(self, g: int, old_active: upols.ConvParams) -> None:
        """Mark every attached lane of group g to fade to its new active
        bank, each from the bank it last played: a lane still owing an
        earlier fade keeps that fade's old bank, every other lane played
        `old_active`. The fade bank stacks those banks (one copy of each)
        before the new one."""
        seg = self._segment(g)
        attached = self._attached_mask[seg]
        pending = self._xfade_pending[seg] & attached
        previous = self._fades.pop(g, None)
        if not attached.any():
            self._xfade_pending[seg] = False
            return
        olds: list = []

        def half_of(params) -> int:
            for i, p in enumerate(olds):
                if p is params:
                    return i
            olds.append(params)
            return len(olds) - 1

        src = np.zeros(self.group_size, np.int64)
        for lane in np.flatnonzero(pending):
            src[lane] = half_of(previous.olds[self._xfade_src[seg][lane]])
        if (attached & ~pending).any():
            src[attached & ~pending] = half_of(old_active)
        params = upols.xfade_conv_params(olds, self._banks[g].params)
        self._fades[g] = _Fade(olds, params, ChainOperands(
            self._mac_bank(params), self._banks[g].synth, None))
        self._xfade_src[seg] = src
        self._xfade_pending[seg] = attached

    def _clear_xfade(self, group: Optional[int] = None) -> None:
        """Drop the hot-swap fades in flight (of `group`, or all)."""
        if group is None:
            self._fades.clear()
            self._xfade_pending[:] = False
        else:
            self._fades.pop(group, None)
            self._xfade_pending[self._segment(group)] = False

    # --- checkpoint / resume -----------------------------------------------

    @torch.inference_mode()
    def snapshot(self, materialize: bool = True) -> dict:
        """A checkpoint of every lane's carry and of the host state that
        interprets it: alignment debt, the attached lanes, the EQ
        crossfade machines (`eq_runtimes`, one per group, on a grouped
        pool). Ring contents (undelivered audio) are transient and not
        captured. `restore` on a pool of the same construction resumes bit
        for bit.

        materialize=True gives numpy leaves (the carry fetched to the
        host); materialize=False keeps device copies (one pass on the card,
        no host readback), for a caller that must not hold serving while
        gigabytes come back: copy under its lock, fetch outside it."""
        self._flush_attach_resets()  # a checkpoint never carries garbage
        if materialize and self.shard_count == 1:
            # One shard: fetched as it lies, with no gather on its device.
            state = _map_carry(_to_host, self._state)
        else:  # gathered in lane order: new tensors, on the host or device
            state = _map_carry(lambda t: t.numpy() if materialize else t,
                               self._gathered("cpu" if materialize
                                              else self.device))
        snap = {
            "state": state,
            "debt": self._debt.copy(),
            "attached": sorted(self._attached),
            "eq_runtime": self.eq_runtime.snapshot(),
            "eq_enabled": self._eq_enabled,
            "groups": self.groups,
        }
        if self.groups > 1:
            snap["eq_runtimes"] = [rt.snapshot() for rt in self.eq_runtimes]
        return snap

    def state_like(self, max_streams: int) -> dict:
        """The carry (and debt) a snapshot of this pool's construction at
        `max_streams` lanes holds, as tensors on the "meta" device, which
        allocate nothing: what such a snapshot is checked against before
        restore(..., resize=True) maps its lanes in."""
        lanes = int(max_streams)
        if lanes % self.groups:
            raise ValueError(f"max_streams ({lanes}) must divide by the "
                             f"{self.groups} profile groups")
        per_group = lanes // self.groups

        def like(t: torch.Tensor, lane_axis: int) -> torch.Tensor:
            shape = list(t.shape)
            shape[lane_axis] = per_group
            return torch.empty(shape, dtype=t.dtype, device="meta")

        convs = self._pack(_map_conv(lambda t: like(t, -1), c)
                           for c in self._conv[::self.shard_count])
        eqs = self._pack(_map_eq(lambda t: like(t, 0), e)
                         for e in self._eq[::self.shard_count])
        return {
            "state": PoolState(convs, eqs),
            "debt": torch.empty((lanes,), dtype=torch.int64, device="meta"),
        }

    def _resize_snapshot_lanes(self, snap: dict, state: PoolState,
                               debt: np.ndarray):
        """Map a snapshot written at another lane count onto this pool: per
        profile group, attached lanes compact to the head of the group's
        new segment in ascending old-id order (one gather per carry tensor);
        free lanes gather the group's old lane 0 as finite filler and are
        reset before any use. Returns (state', debt', attached',
        lane_map {old id: new id})."""
        old_max = int(debt.shape[0])
        if old_max % self.groups:
            raise ValueError(f"snapshot lane count {old_max} does not divide "
                             f"by the pool's {self.groups} profile groups")
        old_q, new_q = old_max // self.groups, self.group_size
        attached_old = sorted(int(s) for s in snap["attached"])
        if any(not (0 <= s < old_max) for s in attached_old):
            raise ValueError(
                f"snapshot attached streams out of range for its own lane "
                f"count {old_max}: {attached_old}")
        per_group = [[s for s in attached_old if s // old_q == g]
                     for g in range(self.groups)]
        for g, lanes in enumerate(per_group):
            if len(lanes) > new_q:
                raise ValueError(
                    f"cannot resize: snapshot group {g} has {len(lanes)} "
                    f"attached lanes, resized pool fits {new_q} per group: "
                    f"detach streams or size the pool to hold them")
        convs = state.conv if _grouped(state.conv) else (state.conv,)
        eqs = state.eq if _grouped(state.eq) else (state.eq,)
        lane_map: dict = {}
        new_convs, new_eqs = [], []
        for g, lanes in enumerate(per_group):
            idx = np.zeros(new_q, np.int64)
            idx[:len(lanes)] = [s - g * old_q for s in lanes]
            lane_map.update({s: g * new_q + r for r, s in enumerate(lanes)})
            take = torch.from_numpy(idx).to(self.device)
            new_convs.append(_map_conv(lambda t: t.index_select(-1, take),
                                       convs[g]))
            new_eqs.append(_map_eq(lambda t: t.index_select(0, take), eqs[g]))
        new_debt = np.zeros(self.max_streams, np.int64)
        for s_old, s_new in lane_map.items():
            new_debt[s_new] = debt[s_old]
        return (PoolState(self._pack(new_convs), self._pack(new_eqs)),
                new_debt, sorted(lane_map.values()), lane_map)

    @torch.inference_mode()
    def restore(self, snap: dict, resize: bool = False) -> Optional[dict]:
        """Load a `snapshot()` (this pool's, or the JAX pool's through
        interop.pool_snapshot_from_numpy). With resize=True the snapshot may
        come from a pool of another max_streams (the same renderer shapes,
        groups and tier): attached lanes keep their exact history and
        compact into their group's new segment in ascending old-id order,
        and the {old id: new id} map is returned for remapping per-lane
        bookkeeping outside the pool; it raises if a group's attached lanes
        do not fit. Returns None when no remap happened.

        Everything is checked before anything changes, so a bad snapshot
        leaves the pool as it was."""
        groups = int(snap.get("groups", 1))
        if groups != self.groups:
            raise ValueError(f"snapshot has {groups} profile groups, pool "
                             f"has {self.groups}")
        want = [(n, tuple(t.shape), t.dtype) for n, t in _carry_leaves(
            self.state_like(self.max_streams)["state"])]
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
        convs = state.conv if _grouped(state.conv) else (state.conv,)
        for conv, parts in zip(convs, self._bank_partitions):
            if not self._paged and not 0 <= int(conv.write_pos) < parts:
                raise ValueError(f"snapshot ring cursor {conv.write_pos} out "
                                 f"of range for {parts} partitions")
        if debt.shape != (self.max_streams,):
            raise ValueError(f"snapshot debt length {debt.shape} vs pool "
                             f"({self.max_streams},)")
        if any(not (0 <= s < self.max_streams) for s in attached):
            raise ValueError(f"snapshot attached streams out of range for "
                             f"max_streams={self.max_streams}: {attached}")
        eq_snaps = (snap["eq_runtimes"] if self.groups > 1
                    and "eq_runtimes" in snap else [snap["eq_runtime"]])
        # The EQ machines are rebuilt on scratch runtimes first: a
        # definition that does not design must fail here, before the pool
        # changes.
        for eq_snap in eq_snaps:
            self._new_eq_runtime().restore(eq_snap)

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
        q = self.group_size
        self._free_by_group = [
            [s for s in range((g + 1) * q - 1, g * q - 1, -1)
             if s not in self._attached]
            for g in range(self.groups)]
        self._pending_out.clear()
        for s in range(self.max_streams):
            self.assembler.reset_stream(s)
            self._out.reset_stream(s)
        for rt, eq_snap in zip(self.eq_runtimes, eq_snaps):
            rt.restore(eq_snap)
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
        channels are dropped; a grouped pool maps them through the
        stream's own group's renderer) or [1, n] mono, duplicated."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 1:
            chunk = chunk[None]
        renderer = self.renderers[self.group_of(stream)]
        speakers = renderer.num_speakers
        if chunk.shape[0] == 1 and speakers > 1:
            chunk = np.repeat(chunk, speakers, axis=0)
        else:
            chunk = renderer.select_input(chunk)
        self.assembler.push(stream, chunk)

    def push_many(self, streams, chunks: np.ndarray) -> None:
        """Batch ingest: chunks [k, C, n] onto k streams in one native call
        (all or nothing on ring space). C may be the speaker count, the
        layout's channel count (unmapped channels drop; a grouped pool
        maps each row through its stream's group's renderer, one gather)
        or 1 (mono)."""
        chunks = np.asarray(chunks, np.float32)
        speakers = self.renderer.num_speakers
        if chunks.shape[1] == 1 and speakers > 1:
            chunks = np.repeat(chunks, speakers, axis=1)
        elif chunks.shape[1] != speakers and self.groups > 1:
            g = np.asarray(streams, np.int64) // self.group_size
            for gu in np.unique(g):
                r = self.renderers[int(gu)]
                if chunks.shape[1] != r.layout_channels:
                    raise ValueError(
                        f"chunk channel count {chunks.shape[1]} matches "
                        f"neither the speaker count ({speakers}) nor group "
                        f"{int(gu)}'s layout ({r.layout_channels})")
            table = np.asarray([r.input_indices for r in self.renderers],
                               np.int64)  # [G, speakers]
            chunks = chunks[np.arange(len(g))[:, None], table[g]]
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
        throwaway state of every shard, and one lane roll per unit.
        include_hotswap=True also runs each variant of a hot-swap round on
        the groups' self-crossfades (a fade bank's shapes are those of any
        later same-carry swap; a grouped fade round runs every group dual).
        The pool's own state, cursors, debt, fades and EQ machines are
        untouched."""
        if self.device.type == "cuda":
            mac_kmajor.build()
        p = self._pack(rt.active.params for rt in self.eq_runtimes)
        L, S = self.groups * self._unit_lanes, self.renderer.num_speakers
        shape = ((L, S, self.blocks_per_step, self.block_size) if self._paged
                 else (L, S, self.block_size))
        variants = PAGED_VARIANTS if self._paged else RING_VARIANTS
        groups = range(self.groups)
        rounds = [(self._conv_params,
                   self._pack(self._operands(rt.active.params, g)
                              for g, rt in enumerate(self.eq_runtimes)),
                   None, None)]
        if include_hotswap:
            fades = [self._self_fade(g) for g in groups]
            rounds.append((self._pack(f[0] for f in fades),
                           self._pack(f[1] for f in fades),
                           torch.zeros(self.step_frames, device=self.device),
                           torch.zeros(L, dtype=torch.bool,
                                       device=self.device)))
        roll = (upols.conv_roll_lanes_paged if self._paged
                else upols.conv_roll_lanes)
        with self._shards.round():
            for s, dev in enumerate(self._shards.devices):
                with self._shards.shard(s):
                    blocks = torch.zeros(shape, device=dev)
                    idx = torch.arange(L, device=dev)
                    p_s = self._replicas.on(p, dev)
                    for crossfading in ((False, True) if self._eq_enabled
                                        else (False,)):
                        for variant in variants:
                            for args in rounds:
                                params, operands, ramp, mask = \
                                    self._replicas.on(args, dev)
                                pool_step_body(
                                    params, p_s, p_s, self._fresh_state(s),
                                    blocks, idx,
                                    self.eq_runtime.transition_length,
                                    self._eq_enabled, crossfading, variant,
                                    operands, ramp, mask)
                    for u in self._units(s):
                        roll(self._fresh_unit_conv(u), idx[:1], idx[:1])
        for dev in set(self._shards.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _begin_eq_round(self):
        """Run every group's EQ control protocol for one round on its
        units' states; returns (eq_states' per unit, params_from and
        params_to per group, crossfading), one crossfading flag for the
        round (a group not mid-ramp blends from == to, which its lanes'
        clipped counters make exact)."""
        # The pool is its own control thread: drain the retirement handoff
        # every round, or the single-slot backpressure wedges the third
        # and every later retarget.
        n = self.shard_count
        states, froms, tos = [], [], []
        crossfading = False
        for g, rt in enumerate(self.eq_runtimes):
            rt.drain_retired_states()
            units, p_from, p_to, _ = rt.begin_block_shards(
                self._eq[g * n:(g + 1) * n])
            states += units
            froms.append(p_from)
            tos.append(p_to)
            crossfading = (crossfading or rt.is_transitioning
                           or rt.pending_target is not None)
        return states, froms, tos, crossfading

    def _fade_round(self, slot: _HostSlot):
        """(params, operands, with_src) of a hot-swap round: each fading
        group's fade bank, the cached self-crossfade of every other group
        (one round shape for any pattern of concurrent swaps), and whether
        some group's fade bank has more than one old half. The lanes that
        blend, and then each lane's old half, are staged in `slot` in
        shard order (copies: the host changes the arrays right after the
        round is queued)."""
        banks = [(f.params, f.operands) if f is not None
                 else self._self_fade(g)
                 for g, f in ((g, self._fades.get(g))
                              for g in range(self.groups))]
        slot.arrays[2][:] = self._xfade_pending[self._shard_order]
        with_src = any(len(f.olds) > 1 for f in self._fades.values())
        if with_src:
            # Half 0 for the lanes of self-crossfading groups, whose
            # _xfade_src may index an earlier, larger fade bank.
            src = np.zeros(self.max_streams, np.int64)
            for g in self._fades:
                seg = self._segment(g)
                src[seg] = self._xfade_src[seg]
            slot.arrays[3][:] = src[self._shard_order]
        return (self._pack(b[0] for b in banks),
                self._pack(b[1] for b in banks), with_src)

    @torch.inference_mode()
    def pump(self, max_rounds: int = 64, on_deliver=None) -> int:
        """Render while any stream has a full step. Returns rounds run.

        `on_deliver`, if given, is called (no arguments) after each
        round's output lands in the output rings. Per round only the
        harvested rows cross the host/device boundary, and round r's
        output is delivered after round r+1 has been dispatched, so its
        copy to the host overlaps the next round's work. The harvest gating
        counts the one in-flight undelivered step against the free space,
        so backpressure is the same as with immediate delivery. On a
        sharded pool every shard runs in every round, on its device and
        stream, from and into its slice of the staging buffers.

        On a failure the pool rebuilds a fresh state, counts it in
        render_errors and re-raises. The steps harvested for the rounds in
        flight are lost: each of their lanes is handed one step of silence
        in their place, so a stream's output keeps its length (a server
        waiting for a stream's last frames is not left waiting)."""
        rounds = 0
        pending = None  # (indices, host slot) awaiting delivery
        harvested = None  # the lanes of the round being built
        inflight = np.zeros(self.max_streams, bool)
        M = self.blocks_per_step
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
                indices, counts = self._harvest(allow, up)
                k = len(indices)
                if k == 0:
                    break
                harvested = indices
                self._roll_rejoining(indices)
                up.arrays[1][:k] = self._local_lane[indices]
                eq_states, p_from, p_to, crossfading = self._begin_eq_round()
                # A hot-swap round if any harvested lane still owes its
                # fade: the fade banks run, pending lanes blend old -> new
                # and the others take the new half.
                fading = bool(self._fades) and bool(
                    self._xfade_pending[indices].any())
                with_src = False
                if fading:
                    conv_params, operands, with_src = self._fade_round(up)
                else:
                    conv_params = self._conv_params
                    operands = self._pack(self._operands(p, g)
                                          for g, p in enumerate(p_to))
                variant = self._variant(indices)
                args = (conv_params, self._pack(p_from), self._pack(p_to),
                        operands, self._xfade_ramp if fading else None)
                starts = np.concatenate([[0], np.cumsum(counts)])
                with self._shards.round():
                    outs = [self._shard_round(s, up, starts, eq_states, args,
                                              crossfading, variant, fading,
                                              with_src)
                            for s in range(self.shard_count)]
                    down.wait()
                    for s, y_rows in enumerate(outs):
                        with self._shards.shard(s):
                            if M > 1:  # [k, M, E, T] -> [k, E, M*T]
                                y_rows = y_rows.transpose(1, 2).reshape(
                                    -1, EARS, step_frames)
                            down.tensors[0][starts[s]:starts[s + 1]].copy_(
                                y_rows, non_blocking=True)
                            down.record(s)
                if fading:
                    self.fade_rounds += 1
                    self._xfade_pending[indices] = False
                    live = self._xfade_pending & self._attached_mask
                    for g in list(self._fades):
                        if not live[self._segment(g)].any():
                            del self._fades[g]  # every lane has faded
                for rt in self.eq_runtimes:
                    rt.after_block(step_frames)
                self._debt[self._attached_mask] += 1
                self._debt[indices] = 0

                if pending is not None:
                    self._deliver(*pending)
                    inflight[pending[0]] = False
                    pending = None
                    if on_deliver is not None:
                        on_deliver()
                pending, harvested = (indices, down), None
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
            self._fresh_carry()
            self._debt[:] = 0
            self._reset_pending[:] = False  # the fresh state is already zero
            self._clear_xfade()  # a zeroed history has nothing to blend
            lost = [] if pending is None else [pending[0]]
            if harvested is not None:
                lost.append(harvested)
            if lost:
                lanes = np.concatenate(lost)
                self._queue_out(lanes, np.zeros(
                    (len(lanes), EARS, step_frames), np.float32))
            self.render_errors += 1
            raise
        return rounds

    def _harvest(self, allow: np.ndarray, slot: _HostSlot):
        """Pop one step from every allowed stream that has one buffered,
        into slot's rows shard by shard (shard s's after shard s-1's, each
        in ascending lane order). Returns (lanes in that order, rows per
        shard)."""
        frames = self.step_frames
        parts, off = [], 0
        for s in range(self.shard_count):
            idx, _ = self.assembler.harvest_allowed(
                self.max_streams - off, allow & (self._shard_of_lane == s),
                frames=frames, out=slot.arrays[0][off:])
            parts.append(idx)
            off += len(idx)
        return np.concatenate(parts), [len(p) for p in parts]

    def _shard_round(self, s: int, up: _HostSlot, starts: np.ndarray,
                     eq_states: list, args: tuple, crossfading: bool,
                     variant: str, fading: bool, with_src: bool):
        """Upload shard s's rows (its slice of `up`) and run its units' chain
        on its device and stream; stores its carry and returns its output
        rows."""
        dev = self._shards.devices[s]
        conv_params, p_from, p_to, operands, ramp = self._replicas.on(args, dev)
        L = self.groups * self._unit_lanes
        rows = slice(int(starts[s]), int(starts[s + 1]))
        with self._shards.shard(s):
            blocks, idx = (t[rows].to(dev, non_blocking=True)
                           for t in up.tensors[:2])
            if self._paged:
                # [k, S, M*T] -> [k, S, M, T]: ring pops are frame-major per
                # channel, so the view is free.
                blocks = blocks.view(blocks.shape[0], blocks.shape[1],
                                     self.blocks_per_step, self.block_size)
            mask = src = None
            if fading:
                lanes = slice(s * L, (s + 1) * L)
                mask = up.tensors[2][lanes].to(dev, non_blocking=True)
                if with_src:
                    src = up.tensors[3][lanes].to(dev, non_blocking=True)
            up.record(s)
            units = self._units(s)
            state, y_rows = pool_step_body(
                conv_params, p_from, p_to,
                PoolState(self._pack(self._conv[u] for u in units),
                          self._pack(eq_states[u] for u in units)),
                blocks, idx, self.eq_runtime.transition_length,
                self._eq_enabled, crossfading, variant, operands, ramp, mask,
                src)
        grouped = _grouped(state.conv)
        for i, u in enumerate(units):
            self._conv[u] = state.conv[i] if grouped else state.conv
            self._eq[u] = state.eq[i] if grouped else state.eq
        return y_rows

    def _variant(self, indices: np.ndarray) -> str:
        k = len(indices)
        tier = "paged" if self._paged else "ring"
        if k != len(self._attached):
            return tier
        if k == self.max_streams:  # every lane (the indices are distinct)
            return f"{tier}_id"
        return f"{tier}_all"

    def _roll_rejoining(self, indices: np.ndarray) -> None:
        """Re-align the harvested lanes that owe alignment debt (modulo
        their group's cycle): exactly those lanes, in place on their
        unit's carry."""
        shift = self._debt[indices] % self._lane_cycles[indices]
        rejoin = shift != 0
        if not rejoin.any():
            return
        lanes, shifts = indices[rejoin].astype(np.int64), shift[rejoin]
        roll = (upols.conv_roll_lanes_paged if self._paged
                else upols.conv_roll_lanes)
        U = self._unit_lanes
        of_unit = lanes // U
        for u in np.unique(of_unit):
            sel = of_unit == u
            dev = self._unit_device(u)
            roll(self._conv[u], torch.from_numpy(lanes[sel] - u * U).to(dev),
                 torch.from_numpy(shifts[sel]).to(dev))
        self.debt_rolls += 1

    def _deliver(self, indices: np.ndarray, slot: _HostSlot) -> None:
        """Queue a round's rendered rows once their copy to the host has
        completed. Harvest gating guarantees ring space, so one atomic
        scatter is the fast path; an unlocked pull racing the round can
        shrink a ring, and the affected blocks then stash in order."""
        slot.wait()
        self._queue_out(indices, slot.arrays[0][: len(indices)])

    def _queue_out(self, indices: np.ndarray, blocks: np.ndarray) -> None:
        """Hand one step per lane (blocks [k, 2, step]) to the output
        rings, stashing in order what does not fit."""
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
        """Host-side counters only: reading them never touches the device.
        `attached_per_group` and a per-group `eq_transitioning` list on a
        grouped pool (None and one flag on a one-profile pool)."""
        attached = self._attached_mask
        per_group = transitioning = None
        if self.groups > 1:
            per_group = [int(attached[self._segment(g)].sum())
                         for g in range(self.groups)]
            transitioning = [rt.is_transitioning for rt in self.eq_runtimes]
        return {
            "max_streams": self.max_streams,
            "attached": len(self._attached),
            "attached_per_group": per_group,
            "groups": self.groups,
            "blocks_per_step": self.blocks_per_step,
            "rounds": self.rounds,
            "blocks_rendered": self.blocks_rendered,
            "render_errors": self.render_errors,
            "stashed_streams": len(self._pending_out),
            "lanes_in_debt": int(
                (self._debt[attached] % self._lane_cycles[attached]
                 != 0).sum()),
            "debt_rolls": self.debt_rolls,
            "variant_rounds": dict(self.variant_rounds),
            "eq_transitioning": (self.eq_runtime.is_transitioning
                                 if transitioning is None else transitioning),
            "hotswap_fading": int((self._xfade_pending & attached).sum()),
            "fade_rounds": self.fade_rounds,
        }
