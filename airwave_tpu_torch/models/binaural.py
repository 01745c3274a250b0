"""The batched virtual-speaker binaural render chain (PyTorch).

Port of the chain steps of airwave_tpu/models/binaural.py: per step,

    (state, x [B, S, T]) -> (state', y [B, 2, T])          chain_step_fn
    (state, x [B, S, M, T]) -> (state', y [B, M, 2, T])    chain_step_multi_fn

spatial (HRIR convolution) then EQ, in that fixed order. BinauralChain
holds the params and everything derived from them as module buffers, and
its forward is the chain step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from airwave_tpu_torch.ops import eq_block, upols


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
                        eq_to: eq_block.EqParams, blocks_per_step: int,
                        k_padded: int) -> ChainOperands:
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
):
    """x [B, S, T] -> (state', y [B, 2, T]). Spatial THEN eq (fixed order).
    With spatial disabled, stereo input passes through and mono is
    duplicated.

    The spatial stage writes state.conv's delay line IN PLACE
    (upols.conv_step), unlike the functional reference: the state passed in
    is consumed, and the returned state holds the same fdl tensor. Reuse
    only the returned state, or pass in a clone of the delay line."""
    conv_state, eq_state = state
    if spatial_enabled:
        bank, synth = (operands.bank, operands.synth) if operands else (None, None)
        conv_state, y = upols.conv_step(conv_params, conv_state, x, bank, synth)
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
    conv_state, eq_state = state
    bank = operands.bank if operands else None
    if eq_enabled and not eq_crossfading:
        conv_state, eq_state, y = eq_block.eq_folded_paged_round(
            conv_params, eq_to, conv_state, eq_state, x, bank,
            operands.synth_folded if operands else None,
        )
        return ChainState(conv_state, eq_state), y
    conv_state, y = upols.conv_step_paged(
        conv_params, conv_state, x, bank, operands.synth if operands else None)
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
