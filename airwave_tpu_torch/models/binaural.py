"""The batched virtual-speaker binaural render chain (PyTorch).

Port of the chain steps of airwave_tpu/models/binaural.py: per step,

    (state, x [B, S, T]) -> (state', y [B, 2, T])          chain_step_fn
    (state, x [B, S, M, T]) -> (state', y [B, M, 2, T])    chain_step_multi_fn

spatial (HRIR convolution) then EQ, in that fixed order. BinauralChain
holds the params and everything derived from them as module buffers, and
its forward is the chain step. BinauralEngine is the live engine: it owns
one batch's carry, the EQ runtime and the crossfaded HRIR hot-swap, and
steps one block at a time from numpy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.device import (DEFAULT_DEVICE, apply_precision_policy,
                                      resolve_device)
from airwave_tpu_torch.graph.eq_runtime import EqualizerRuntime
from airwave_tpu_torch.graph.renderer import RendererState
from airwave_tpu_torch.io.apo import EqualizerDefinition
from airwave_tpu_torch.ops import eq_block, upols
from airwave_tpu_torch.utils.profiling import CHAIN_STEP, CONV_SYNTHESIS, span


class ChainState(NamedTuple):
    conv: "upols.ConvState | upols.PagedConvState"
    eq: eq_block.EqState


class ChainOperands(NamedTuple):
    """Operands derived from the params alone, built once per bank and
    passed to every step (eager PyTorch does not hoist loop invariants)."""

    bank: torch.Tensor            # upols.single_block_bank or upols.paged_bank
    synth: torch.Tensor           # plain synthesis weights [T, Q*Kp]
    synth_folded: "torch.Tensor | None"  # paged synthesis with eq_to folded in


def make_chain_operands(conv_params: upols.ConvParams,
                        eq_to: "eq_block.EqParams | None", blocks_per_step: int,
                        k_padded: int) -> ChainOperands:
    """The operands of `conv_params` for M = blocks_per_step; eq_to is
    folded into the paged synthesis and not read at M = 1."""
    M = int(blocks_per_step)
    if M > 1:
        return ChainOperands(
            bank=upols.paged_bank(conv_params, M, k_padded),
            synth=upols.project_weights(conv_params, k_padded),
            synth_folded=upols.project_weights(
                conv_params, k_padded, eq_block.fold_post(eq_to)),
        )
    return ChainOperands(
        bank=upols.single_block_bank(conv_params, k_padded),
        synth=upols.project_weights(conv_params, k_padded),
        synth_folded=None,
    )


def chain_step_fn(
    conv_params: upols.ConvParams,
    eq_from: eq_block.EqParams,
    eq_to: eq_block.EqParams,
    state: ChainState,
    x: torch.Tensor,
    transition_length: int,
    spatial_enabled: bool,
    eq_enabled: bool,
    eq_crossfading: bool = True,
    operands: "ChainOperands | None" = None,
    xfade_ramp: "torch.Tensor | None" = None,
):
    """x [B, S, T] -> (state', y [B, 2, T]). Spatial THEN eq (fixed order).
    With spatial disabled, stereo input passes through and mono is
    duplicated.

    `xfade_ramp` [T] (with conv_params = upols.xfade_conv_params(old, new)
    and operands built from them) runs one block of a crossfaded HRIR
    hot-swap: the dual bank's halves blend per sample BEFORE the EQ, so the
    EQ state is driven by the blended signal, as a physical time-varying
    filter would drive it.

    The spatial stage writes state.conv's delay line IN PLACE
    (upols.conv_step), unlike the functional reference: the state passed in
    is consumed, and the returned state holds the same fdl tensor. Reuse
    only the returned state, or pass in a clone of the delay line."""
    with span(CHAIN_STEP):
        conv_state, eq_state = state
        if spatial_enabled:
            bank, synth = ((operands.bank, operands.synth) if operands
                           else (None, None))
            conv_state, y = upols.conv_step(conv_params, conv_state, x, bank,
                                            synth)
            if xfade_ramp is not None:
                with span(CONV_SYNTHESIS):
                    y = upols.xfade_blend(y, xfade_ramp)
        elif x.shape[1] >= 2:
            y = x[:, :2, :]
        else:
            y = torch.cat([x, x], dim=1)
        if eq_enabled:
            eq_state, y = eq_block.eq_step(
                eq_from, eq_to, eq_state, y, transition_length, eq_crossfading
            )
        return ChainState(conv_state, eq_state), y


def chain_step_multi_fn(
    conv_params: upols.ConvParams,
    eq_from: eq_block.EqParams,
    eq_to: eq_block.EqParams,
    state: ChainState,
    x: torch.Tensor,
    transition_length: int,
    eq_enabled: bool,
    eq_crossfading: bool = False,
    operands: "ChainOperands | None" = None,
):
    """Throughput (bake) variant: x [B, S, M, T] -> (state', y [B, M, 2, T]).

    The spatial stage renders all M blocks against one delay-line read
    (conv_params built with lookahead=M, state.conv a PagedConvState); the
    stateful EQ then runs the M outputs in order, so the result is block
    for block M chain_step_fn calls. In steady state (eq_crossfading=False)
    the EQ's FIR and state drive are folded into the synthesis weights and
    only its state recurrence is left (eq_block.eq_folded_paged_round)."""
    with span(CHAIN_STEP):
        conv_state, eq_state = state
        bank = operands.bank if operands else None
        if eq_enabled and not eq_crossfading:
            conv_state, eq_state, y = eq_block.eq_folded_paged_round(
                conv_params, eq_to, conv_state, eq_state, x, bank,
                operands.synth_folded if operands else None,
            )
            return ChainState(conv_state, eq_state), y
        conv_state, y = upols.conv_step_paged(
            conv_params, conv_state, x, bank,
            operands.synth if operands else None)
        if eq_enabled:
            outs = []
            for m in range(x.shape[2]):
                eq_state, ym = eq_block.eq_step(
                    eq_from, eq_to, eq_state, y[:, m], transition_length,
                    eq_crossfading,
                )
                outs.append(ym)
            y = torch.stack(outs, dim=1)
        return ChainState(conv_state, eq_state), y


class BinauralChain(nn.Module):
    """The spatial+EQ chain as a module: conv and EQ params, and the
    operands derived from them, are buffers (so `.to(device)` moves them
    together); forward(state, x) is one chain step.

    blocks_per_step=1 steps one block at a time (chain_step_fn, zero added
    latency; it consumes the state passed in, see there); M > 1 renders M
    blocks per delay-line read (chain_step_multi_fn; conv_params must be
    built with lookahead=M; it leaves the state passed in intact)."""

    def __init__(self, conv_params: upols.ConvParams,
                 eq_from: eq_block.EqParams, eq_to: eq_block.EqParams,
                 transition_length: int, block_size: int,
                 blocks_per_step: int = 1, eq_enabled: bool = True):
        super().__init__()
        self.transition_length = int(transition_length)
        self.blocks_per_step = int(blocks_per_step)
        self.eq_enabled = bool(eq_enabled)
        for name, t in conv_params._asdict().items():
            self.register_buffer(f"conv_{name}", t)
        for prefix, p in (("eq_from", eq_from), ("eq_to", eq_to)):
            for name, t in p._asdict().items():
                self.register_buffer(f"{prefix}_{name}", t)
        ops = make_chain_operands(conv_params, eq_to, self.blocks_per_step,
                                  upols.padded_bin_count(block_size))
        for name, t in ops._asdict().items():
            self.register_buffer(name, t)

    def _params(self, cls, prefix):
        return cls(*(getattr(self, f"{prefix}_{f}") for f in cls._fields))

    @property
    def conv_params(self) -> upols.ConvParams:
        return self._params(upols.ConvParams, "conv")

    @property
    def eq_from(self) -> eq_block.EqParams:
        return self._params(eq_block.EqParams, "eq_from")

    @property
    def eq_to(self) -> eq_block.EqParams:
        return self._params(eq_block.EqParams, "eq_to")

    @property
    def operands(self) -> ChainOperands:
        return ChainOperands(*(getattr(self, f) for f in ChainOperands._fields))

    def forward(self, state: ChainState, x: torch.Tensor,
                eq_crossfading: bool = False):
        if self.blocks_per_step > 1:
            return chain_step_multi_fn(
                self.conv_params, self.eq_from, self.eq_to, state, x,
                self.transition_length, self.eq_enabled, eq_crossfading,
                self.operands,
            )
        return chain_step_fn(
            self.conv_params, self.eq_from, self.eq_to, state, x,
            self.transition_length, spatial_enabled=True,
            eq_enabled=self.eq_enabled, eq_crossfading=eq_crossfading,
            operands=self.operands,
        )


class BinauralEngine:
    """The live engine: one batch's device carry, the EQ runtime and the
    HRIR hot-swap, stepped one block at a time (process_block, numpy in and
    out) on `device` (the card by default; pass device="cpu" for the CPU).

    Port of airwave_tpu/models/binaural.py:BinauralEngine, the analog of
    the reference's AudioEffectGraph + HRIRManager render path, batched.
    Renderer swaps crossfade over the preserved history (set_renderer); EQ
    retargets crossfade through the EqualizerRuntime protocol. The operands
    derived from the active bank, and from the dual bank of a fade, are
    built once per bank change (ChainOperands), never per block."""

    def __init__(
        self,
        batch: int,
        sample_rate: float,
        block_size: int = 512,
        renderer: Optional[RendererState] = None,
        config: AirwaveConfig = DEFAULT_CONFIG,
        device: "torch.device | str" = DEFAULT_DEVICE,
    ) -> None:
        self.device = resolve_device(device)
        apply_precision_policy()
        self.batch = int(batch)
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.config = config
        self._k_padded = upols.padded_bin_count(self.block_size)
        self.eq_runtime = EqualizerRuntime(sample_rate, block_size,
                                           config.eq_state_dim, config,
                                           device=self.device)
        self._eq_active = False
        self.renderer: Optional[RendererState] = None
        self._state: Optional[ChainState] = None
        # The active bank (the renderer's params, zero-padded to the carry's
        # partition count after a crossfaded shorter-HRIR swap) with its
        # operands, and the crossfade in flight: the dual bank, its
        # operands and the per-block ramp segments still to play.
        self._conv_params: Optional[upols.ConvParams] = None
        self._operands: Optional[ChainOperands] = None
        self._xfade_params: Optional[upols.ConvParams] = None
        self._xfade_operands: Optional[ChainOperands] = None
        self._xfade_segments: list = []
        if renderer is not None:
            self.set_renderer(renderer)
        else:
            self._alloc_state(num_speakers=2, partitions=1)

    # --- control path ------------------------------------------------------

    def _alloc_state(self, num_speakers: int, partitions: int) -> None:
        eq = (self._state.eq if self._state is not None
              else eq_block.make_eq_state(self.batch, 2,
                                          self.config.eq_state_dim,
                                          self.device))
        self._state = ChainState(
            conv=upols.make_conv_state(self.batch, num_speakers, partitions,
                                       self.block_size, self.device),
            eq=eq)

    def _clear_xfade(self) -> None:
        self._xfade_params = None
        self._xfade_operands = None
        self._xfade_segments = []

    @torch.inference_mode()
    def set_renderer(self, renderer: Optional[RendererState],
                     crossfade: bool = True) -> bool:
        """Hot-swap the HRIR renderer. Returns True when the swap
        crossfaded, False when the history was reset.

        With crossfade=True a swap onto the same speakers whose bank fits
        the carry (a shorter bank is zero-padded onto it) keeps the whole
        conv history, and the next 20 ms of output blend old -> new per
        sample: the ideal time-varying filter (upols.xfade_conv_params).
        crossfade=False, no prior renderer, or a bank longer than the carry
        resets the history (the reference's fresh-engine semantics) and
        reallocates the carry when its shape changes. A second swap
        mid-fade is newest-wins: the fade restarts toward the newest bank
        FROM the blend the output currently hears, the interrupted fade's
        banks lerped at the ramp position the next sample would have used
        (upols.lerp_bank), so the output filter does not step."""
        old = self.renderer
        old_params = self._conv_params
        self.renderer = renderer
        if renderer is None:
            self._conv_params = self._operands = None
            self._clear_xfade()
            return False
        new_params = upols.ConvParams(
            *(t.to(self.device) for t in renderer.conv_params))
        if (crossfade and old is not None and old_params is not None
                and old.num_speakers == renderer.num_speakers
                and renderer.partition_count <= old_params.partition_count):
            if self._xfade_params is not None and self._xfade_segments:
                r0 = float(self._xfade_segments[0][0])
                E = old_params.num_ears
                prev_old = self._xfade_params._replace(
                    Gflip2=self._xfade_params.Gflip2[:, :E])
                old_params = upols.lerp_bank(prev_old, old_params, r0)
            self._conv_params = upols.pad_conv_params(
                new_params, old_params.partition_count)
            self._operands = make_chain_operands(self._conv_params, None, 1,
                                                 self._k_padded)
            self._xfade_params = upols.xfade_conv_params(old_params,
                                                         self._conv_params)
            self._xfade_operands = make_chain_operands(
                self._xfade_params, None, 1, self._k_padded)
            T = self.block_size
            fade = self.config.transition_length(self.sample_rate)
            full = torch.from_numpy(
                upols.xfade_ramp(fade, fade + (-fade) % T)).to(self.device)
            self._xfade_segments = list(full.split(T))
            return True
        self._conv_params = new_params
        self._operands = make_chain_operands(new_params, None, 1,
                                             self._k_padded)
        self._clear_xfade()
        if (old is None or self._state is None
                or (old.num_speakers, old_params.partition_count)
                != (renderer.num_speakers, renderer.partition_count)):
            self._alloc_state(renderer.num_speakers,
                              renderer.partition_count)
        else:
            self._state = ChainState(conv=upols.conv_reset(self._state.conv),
                                     eq=self._state.eq)
        return False

    @property
    def spatial_ready(self) -> bool:
        return self.renderer is not None

    def set_equalizer(self, definition: Optional[EqualizerDefinition]) -> None:
        """Live retarget; the EQ stays in the chain for the unity ramp when
        the definition is removed (ref AudioEffectGraph.swift:147-151)."""
        self.eq_runtime.set_target(definition)
        self._eq_active = True

    def prepare_equalizer(self,
                          definition: Optional[EqualizerDefinition]) -> None:
        """Full (re)prepare; a None definition takes the EQ out of the
        chain (ref AudioEffectGraph.swift:94-114)."""
        self.eq_runtime.set_target(definition)
        self._eq_active = definition is not None

    def reset(self) -> None:
        if self._state is not None:
            self._state = ChainState(conv=upols.conv_reset(self._state.conv),
                                     eq=self._state.eq)
        # A zeroed history has nothing to blend: jump to the fade target.
        self._clear_xfade()
        self.eq_runtime.reset()

    # --- render path ---------------------------------------------------------

    @torch.inference_mode()
    def process_block(self, x: np.ndarray) -> np.ndarray:
        """x [B, S, T] float32 -> y [B, 2, T] float32 (one block)."""
        x = np.asarray(x, np.float32)
        if x.shape[0] != self.batch or x.shape[2] != self.block_size:
            raise ValueError(f"block {x.shape}: expected [{self.batch}, S, "
                             f"{self.block_size}]")
        spatial = self.spatial_ready
        if spatial and x.shape[1] != self.renderer.num_speakers:
            raise ValueError(f"block {x.shape} has {x.shape[1]} channels, the "
                             f"renderer {self.renderer.num_speakers} speakers")
        # The engine is its own control thread: drain the retirement handoff
        # every block, or the single-slot backpressure wedges every retarget
        # after the second completed transition.
        self.eq_runtime.drain_retired_states()
        eq_state, p_from, p_to, _ = self.eq_runtime.begin_block(self._state.eq)
        ramp = None
        if spatial and self._xfade_segments:
            conv_params, operands = self._xfade_params, self._xfade_operands
            ramp = self._xfade_segments.pop(0)
            if not self._xfade_segments:
                self._xfade_params = self._xfade_operands = None
        elif spatial:
            conv_params, operands = self._conv_params, self._operands
        else:
            conv_params, operands = _dummy_conv_params(self.block_size), None
        crossfading = (self.eq_runtime.is_transitioning
                       or self.eq_runtime.pending_target is not None)
        self._state, y = chain_step_fn(
            conv_params, p_from, p_to, ChainState(self._state.conv, eq_state),
            torch.from_numpy(x).to(self.device),
            self.eq_runtime.transition_length, spatial, self._eq_active,
            crossfading, operands, xfade_ramp=ramp)
        self.eq_runtime.after_block(self.block_size)
        # A copy: on the CPU the passthrough output is a view of x.
        return y.to("cpu", copy=True).numpy()

    @property
    def state(self) -> ChainState:
        return self._state


@functools.lru_cache(maxsize=4)
def _dummy_conv_params(block_size: int) -> upols.ConvParams:
    """Placeholder params for the passthrough topology (never read)."""
    return upols.make_conv_params(np.zeros((1, 2, 1), np.float32), block_size,
                                  device="cpu")
