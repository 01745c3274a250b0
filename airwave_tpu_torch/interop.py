"""Carry params and state between the JAX package and this port.

The carry layouts are identical (delay line [Kp, S, P2, 2, B], pages
[Kp, S, 2, M, B], write cursor, EqState), so a JAX bake can be continued
by the port and the other way round. The *_from_numpy functions take the
JAX NamedTuples (their arrays go through np.asarray; jax itself is never
imported here) and copy them onto `device`. The *_to_numpy functions
return the port's NamedTuples holding numpy arrays, with the reference's
field names, from which the JAX NamedTuples are built field by field.

The serving pool's carry (PoolState: conv and EQ carry, both tiers) moves
the same way, and renderer_from_numpy turns a JAX RendererState (its conv
params read as numpy arrays) into the port's, so a JAX pool's carry can be
continued by the port's pool. Like every entry point of the port, the
*_from_numpy functions put their tensors on the card unless given
device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.graph.renderer import RendererState
from airwave_tpu_torch.models.binaural import ChainState
from airwave_tpu_torch.ops import eq_block, upols
from airwave_tpu_torch.runtime.stream_pool import PoolState


def _tensor(a, device, dtype=np.float32) -> torch.Tensor:
    # torch.tensor copies: the port updates state in place, and the source
    # buffers belong to the caller.
    return torch.tensor(np.asarray(a, dtype), device=resolve_device(device))


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def conv_params_from_numpy(params, device=DEFAULT_DEVICE) -> upols.ConvParams:
    return upols.ConvParams(*(_tensor(a, device) for a in params))


def eq_params_from_numpy(params, device=DEFAULT_DEVICE) -> eq_block.EqParams:
    return eq_block.EqParams(*(_tensor(a, device) for a in params))


def eq_state_from_numpy(state, device=DEFAULT_DEVICE) -> eq_block.EqState:
    return eq_block.EqState(
        s_from=_tensor(state.s_from, device),
        s_to=_tensor(state.s_to, device),
        counter=_tensor(state.counter, device, np.int32),
    )


def conv_state_from_numpy(state, device=DEFAULT_DEVICE):
    if hasattr(state, "pages"):
        return upols.PagedConvState(
            pages=tuple(_tensor(pg, device) for pg in state.pages))
    return upols.ConvState(fdl=_tensor(state.fdl, device),
                           write_pos=int(np.asarray(state.write_pos)))


def chain_state_from_numpy(state, device=DEFAULT_DEVICE) -> ChainState:
    return ChainState(conv=conv_state_from_numpy(state.conv, device),
                      eq=eq_state_from_numpy(state.eq, device))


def conv_params_to_numpy(params: upols.ConvParams) -> upols.ConvParams:
    return upols.ConvParams(*(_array(t) for t in params))


def eq_params_to_numpy(params: eq_block.EqParams) -> eq_block.EqParams:
    return eq_block.EqParams(*(_array(t) for t in params))


def eq_state_to_numpy(state: eq_block.EqState) -> eq_block.EqState:
    return eq_block.EqState(*(_array(t) for t in state))


def conv_state_to_numpy(state):
    if isinstance(state, upols.PagedConvState):
        return upols.PagedConvState(pages=tuple(_array(pg) for pg in state.pages))
    return upols.ConvState(fdl=_array(state.fdl),
                           write_pos=np.int32(state.write_pos))


def chain_state_to_numpy(state: ChainState) -> ChainState:
    return ChainState(conv=conv_state_to_numpy(state.conv),
                      eq=eq_state_to_numpy(state.eq))


def pool_state_from_numpy(state, device=DEFAULT_DEVICE) -> PoolState:
    return PoolState(conv=conv_state_from_numpy(state.conv, device),
                     eq=eq_state_from_numpy(state.eq, device))


def pool_state_to_numpy(state: PoolState) -> PoolState:
    return PoolState(conv=conv_state_to_numpy(state.conv),
                     eq=eq_state_to_numpy(state.eq))


def renderer_from_numpy(renderer, device=DEFAULT_DEVICE) -> RendererState:
    """The port's RendererState from a JAX one: the same host fields, and
    its conv params copied onto `device`."""
    return RendererState(
        conv_params=conv_params_from_numpy(renderer.conv_params, device),
        speakers=tuple(renderer.speakers),
        sample_rate=float(renderer.sample_rate),
        block_size=int(renderer.block_size),
        generation=int(renderer.generation),
        input_channels=int(renderer.input_channels),
        input_indices=tuple(renderer.input_indices),
        lookahead=int(renderer.lookahead),
    )
