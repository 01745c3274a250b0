"""Carry params and state between the JAX package and this port.

The carry layouts are identical (delay line [Kp, S, P2, 2, B], pages
[Kp, S, 2, M, B], write cursor, EqState), so a JAX bake can be continued
by the port and the other way round. The *_from_numpy functions take the
JAX NamedTuples (their arrays go through np.asarray; jax itself is never
imported here) and copy them onto `device`. The *_to_numpy functions
return the port's NamedTuples holding numpy arrays, with the reference's
field names, from which the JAX NamedTuples are built field by field.

The serving pool's carry (PoolState: conv and EQ carry, both tiers, and
a grouped pool's G-tuples of them) moves the same way, and renderer_from_numpy turns a JAX RendererState (its conv
params read as numpy arrays) into the port's, so a JAX pool's carry can be
continued by the port's pool. Like every entry point of the port, the
*_from_numpy functions put their tensors on the card unless given
device="cpu".

Whole pool snapshots (StreamPool.snapshot) move both ways too. Their EQ
runtime part holds EqualizerDefinitions and biquad designs, whose types
differ between the packages (the filter type is an enum of each package):
pool_snapshot_from_numpy rebuilds them as the port's, and
pool_snapshot_to_numpy as the types of the io.apo and biquad_design
modules it is given, which is how a caller that imports both packages gets
the JAX package's without this module importing it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.graph.renderer import RendererState
from airwave_tpu_torch.io import apo as _apo
from airwave_tpu_torch.ops import biquad_design as _biquad_design
from airwave_tpu_torch.models.binaural import ChainState
from airwave_tpu_torch.ops import eq_block, upols
from airwave_tpu_torch.runtime.stream_pool import PoolState


def _tensor(a, device, dtype=np.float32) -> torch.Tensor:
    # torch.tensor copies: the port updates state in place, and the source
    # buffers belong to the caller.
    return torch.tensor(np.asarray(a, dtype), device=resolve_device(device))


def _array(t) -> np.ndarray:
    # A snapshot's carry may already hold numpy arrays.
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


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
    """A pool carry, one-profile or grouped (G-tuples of conv and EQ
    carries), on `device`."""
    if type(state.conv) is tuple:
        return PoolState(
            conv=tuple(conv_state_from_numpy(c, device) for c in state.conv),
            eq=tuple(eq_state_from_numpy(e, device) for e in state.eq))
    return PoolState(conv=conv_state_from_numpy(state.conv, device),
                     eq=eq_state_from_numpy(state.eq, device))


def pool_state_to_numpy(state: PoolState) -> PoolState:
    if type(state.conv) is tuple:
        return PoolState(conv=tuple(conv_state_to_numpy(c) for c in state.conv),
                         eq=tuple(eq_state_to_numpy(e) for e in state.eq))
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


def eq_definition_convert(definition, apo=_apo):
    """An EqualizerDefinition (of either package) rebuilt from the types of
    the io.apo module `apo` (the port's by default), field by field, each
    filter's type by its value. None stays None."""
    if definition is None:
        return None
    filters = tuple(
        apo.EqualizerFilter(**{
            **{f.name: getattr(flt, f.name)
               for f in dataclasses.fields(apo.EqualizerFilter)},
            "type": apo.FilterType(flt.type.value),
        })
        for flt in definition.filters)
    return apo.EqualizerDefinition(preamp_db=definition.preamp_db,
                                   filters=filters)


def eq_runtime_snapshot_convert(snap: dict, apo=_apo,
                                biquad_design=_biquad_design) -> dict:
    """An EqualizerRuntime.snapshot() (of either package) with its
    definitions and biquad designs rebuilt from the types of `apo` and
    `biquad_design` (the port's by default)."""
    def convert(item):
        if item is None:
            return None
        tag, definition, *rest = item
        out = (tag, eq_definition_convert(definition, apo))
        if rest:
            preamp, coeffs = rest[0]
            out += ((preamp, [biquad_design.BiquadCoefficients(
                c.b0, c.b1, c.b2, c.a1, c.a2) for c in coeffs]),)
        return out

    return {**snap, **{key: convert(snap[key])
                       for key in ("active", "transition_from", "pending")}}


def pool_snapshot_from_numpy(snap: dict, device=DEFAULT_DEVICE) -> dict:
    """A JAX StreamPool.snapshot() (materialized) as the port's
    StreamPool.restore takes it: the carry as the port's NamedTuples on
    `device`, the EQ runtime's definitions and designs as the port's
    types; debt, attached lanes and flags as they are."""
    return _convert_eq_runtimes(
        {**snap,
         "state": pool_state_from_numpy(snap["state"], device),
         "debt": np.asarray(snap["debt"], np.int64).copy(),
         "attached": [int(s) for s in snap["attached"]]},
        _apo, _biquad_design)


def pool_snapshot_to_numpy(snap: dict, apo, biquad_design) -> dict:
    """The port's StreamPool.snapshot() for the JAX pool: the carry as the
    port's NamedTuples of numpy arrays (the reference's field names; the
    JAX NamedTuples are built from them field by field), the EQ runtime's
    definitions and designs as the types of the given io.apo and
    biquad_design modules (pass the JAX package's)."""
    return _convert_eq_runtimes(
        {**snap,
         "state": pool_state_to_numpy(snap["state"]),
         "debt": np.asarray(snap["debt"], np.int64).copy()},
        apo, biquad_design)


def _convert_eq_runtimes(snap: dict, apo, biquad_design) -> dict:
    """A pool snapshot with its EQ machine, and a grouped pool's per-group
    `eq_runtimes`, converted to the types of `apo` and `biquad_design`."""
    snap["eq_runtime"] = eq_runtime_snapshot_convert(snap["eq_runtime"], apo,
                                                     biquad_design)
    if "eq_runtimes" in snap:
        snap["eq_runtimes"] = [eq_runtime_snapshot_convert(s, apo,
                                                           biquad_design)
                               for s in snap["eq_runtimes"]]
    return snap
