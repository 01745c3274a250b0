"""Block state-space parametric EQ with vectorized crossfade (PyTorch).

Port of airwave_tpu/ops/eq_block.py. The cascade is lowered host-side
(ops/biquad_design.block_ssm) to block form; one step processes a [B, C, T]
block with

    y    = x @ Hm^T + s0 @ O^T          (Toeplitz FIR + state output)
    s_T  = s0 @ A_T^T + x @ G^T

in strict fp32 matmuls. Crossfade: the carry holds two cascade states
(from/to) and a per-stream sample counter; a crossfading block runs both
cascades and blends with the exact per-sample ramp
(counter + t + 1) / L clipped to [0, 1].
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import upols

# Counter value meaning "no transition in progress" (golden-tested: any
# value >= the longest supported transition length works).
COUNTER_IDLE = int(np.int32(1 << 24))


class EqParams(NamedTuple):
    Hm: torch.Tensor   # [T, T] lower-triangular Toeplitz, Hm[t, k] = h[t - k]
    O: torch.Tensor    # [T, N]
    A_T: torch.Tensor  # [N, N]
    G: torch.Tensor    # [N, T]


class EqState(NamedTuple):
    s_from: torch.Tensor   # [B, C, N] float32
    s_to: torch.Tensor     # [B, C, N] float32
    counter: torch.Tensor  # [B] int32, samples elapsed in the crossfade


def make_eq_params(
    coefficients: Sequence[bd.BiquadCoefficients],
    preamp_linear: float,
    block_size: int,
    state_dim: int = 128,
    dtype: torch.dtype = torch.float32,
    device: "torch.device | str" = DEFAULT_DEVICE,
) -> EqParams:
    ssm = bd.block_ssm(coefficients, preamp_linear, block_size, state_dim)
    T = block_size
    toeplitz = np.zeros((T, T), np.float64)
    for t in range(T):
        toeplitz[t, : t + 1] = ssm.h[t::-1]
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, np_dtype), device=device)

    return EqParams(Hm=tensor(toeplitz), O=tensor(ssm.O),
                    A_T=tensor(ssm.A_T), G=tensor(ssm.G))


def unity_eq_params(block_size: int, state_dim: int = 128,
                    device: "torch.device | str" = DEFAULT_DEVICE) -> EqParams:
    """The unity state: no filters, preamp 1."""
    return make_eq_params([], 1.0, block_size, state_dim, device=device)


def make_eq_state(batch: int, channels: int = 2, state_dim: int = 128,
                  device: "torch.device | str" = DEFAULT_DEVICE) -> EqState:
    device = resolve_device(device)
    return EqState(
        s_from=torch.zeros((batch, channels, state_dim), device=device),
        s_to=torch.zeros((batch, channels, state_dim), device=device),
        counter=torch.full((batch,), COUNTER_IDLE, dtype=torch.int32,
                           device=device),
    )


def _advance(counter: torch.Tensor, samples: int) -> torch.Tensor:
    return torch.clamp_max(counter + samples, COUNTER_IDLE)


def _cascade_block(params: EqParams, s: torch.Tensor, x: torch.Tensor):
    """Run one cascade over a block. x [B, C, T], s [B, C, N]."""
    y = x @ params.Hm.T + s @ params.O.T
    s_next = s @ params.A_T.T + x @ params.G.T
    return y, s_next


def eq_step(
    params_from: EqParams,
    params_to: EqParams,
    state: EqState,
    x: torch.Tensor,
    transition_length: int,
    crossfade_active: bool = True,
):
    """One EQ block: x [B, C, T] -> (state', y [B, C, T]).

    With crossfade_active=False (steady state, no stream mid-ramp) only the
    'to' cascade runs."""
    T = x.shape[-1]
    y_to, s_to = _cascade_block(params_to, state.s_to, x)

    if not crossfade_active:
        return EqState(s_from=state.s_from, s_to=s_to,
                       counter=_advance(state.counter, T)), y_to

    y_from, s_from = _cascade_block(params_from, state.s_from, x)
    t = torch.arange(T, dtype=torch.float32, device=x.device)
    progress = torch.clamp(
        (state.counter[:, None].to(torch.float32) + t + 1.0)
        / float(transition_length),
        0.0,
        1.0,
    )  # [B, T]
    w = progress[:, None, :]
    y = y_from * (1.0 - w) + y_to * w
    return EqState(s_from=s_from, s_to=s_to,
                   counter=_advance(state.counter, T)), y


def eq_apply_folded(params: EqParams, state: EqState, fir: torch.Tensor,
                    drive: torch.Tensor):
    """M-block EQ from pre-folded responses (bake path, steady state only):
    fir [B, M, C, T], drive [B, M, C, N] -> (state', y [B, M, C, T]).

    The FIR (x @ Hm^T) and state drive (x @ G^T) were folded into the
    convolution's synthesis (eq_folded_paged_round), so what is left is the
    sequential [N]-dim state recurrence over the M blocks and one batched
    state-to-output matmul — block for block the steady eq_step."""
    M = fir.shape[1]
    s = state.s_to
    states = []
    for m in range(M):
        states.append(s)
        s = s @ params.A_T.T + drive[:, m]
    sm = torch.stack(states, dim=1)  # [B, M, C, N]
    y = fir + sm @ params.O.T
    return EqState(s_from=state.s_from, s_to=s,
                   counter=_advance(state.counter, M * fir.shape[-1])), y


def fold_post(eq_to: EqParams) -> torch.Tensor:
    """The post-matrix [T, T+N] folded into the paged synthesis: the EQ's
    Toeplitz FIR next to its state-drive map."""
    return torch.cat([eq_to.Hm.T, eq_to.G.T], dim=1)


def eq_folded_paged_round(conv_params, eq_to: EqParams, conv_state,
                          eq_state: EqState, x: torch.Tensor,
                          bank: "torch.Tensor | None" = None,
                          synth: "torch.Tensor | None" = None,
                          active_mask: "torch.Tensor | None" = None):
    """One steady-state M-block round with the EQ folded into the synthesis
    DFT: x [B, S, M, T] -> (conv_state', eq_state', y [B, M, C, T]).

    conv_step_paged_raw -> ONE paged_project pass over the [Hm^T | G^T]
    post-matrix (Ykm is read once) -> fir/drive split -> eq_apply_folded.
    `bank` (upols.paged_bank) and `synth` (upols.project_weights with
    post=fold_post(eq_to)) may be passed in by stepping loops. active_mask
    is the serving pool's idle-lane preservation
    (upols.conv_step_paged_raw); the EQ state of idle lanes is the
    caller's to restore."""
    conv_state, Ykm = upols.conv_step_paged_raw(conv_params, conv_state, x,
                                                bank, active_mask)
    T = x.shape[-1]
    if synth is None:
        synth = upols.project_weights(conv_params, Ykm.shape[3],
                                      fold_post(eq_to))
    both = upols.paged_project(conv_params, Ykm, synth=synth)
    fir, drive = both[..., :T], both[..., T:]
    eq_state, y = eq_apply_folded(eq_to, eq_state, fir, drive)
    return conv_state, eq_state, y


# --- Lane state ops of the serving pool --------------------------------------
# Each takes an optional [B] bool mask; the counter stays int32 throughout.


def eq_begin_transition(state: EqState,
                        stream_mask: "torch.Tensor | None" = None) -> EqState:
    """Host-published retarget: 'to' becomes 'from', counter restarts. The
    caller swaps params_from <- params_to and installs the new params_to;
    freshly targeted cascades start from zero state."""
    if stream_mask is None:
        return EqState(s_from=state.s_to, s_to=torch.zeros_like(state.s_to),
                       counter=torch.zeros_like(state.counter))
    m = stream_mask.to(torch.bool)
    return EqState(
        s_from=torch.where(m[:, None, None], state.s_to, state.s_from),
        s_to=state.s_to.masked_fill(m[:, None, None], 0.0),
        counter=state.counter.masked_fill(m, 0),
    )


def eq_finish_transition(state: EqState,
                         stream_mask: "torch.Tensor | None" = None) -> EqState:
    """Control-clock transition end: idle the (masked) lanes' counters, so
    a lane that paused mid-ramp jumps to the target rather than resuming
    the blend in a later crossfading block."""
    if stream_mask is None:
        counter = torch.full_like(state.counter, COUNTER_IDLE)
    else:
        counter = state.counter.masked_fill(stream_mask.to(torch.bool),
                                            COUNTER_IDLE)
    return EqState(s_from=state.s_from, s_to=state.s_to, counter=counter)


def eq_reset(state: EqState,
             stream_mask: "torch.Tensor | None" = None) -> EqState:
    """Zero filter histories (all lanes, or the masked ones)."""
    if stream_mask is None:
        return EqState(s_from=torch.zeros_like(state.s_from),
                       s_to=torch.zeros_like(state.s_to),
                       counter=state.counter)
    m = stream_mask.to(torch.bool)[:, None, None]
    return EqState(s_from=state.s_from.masked_fill(m, 0.0),
                   s_to=state.s_to.masked_fill(m, 0.0),
                   counter=state.counter)
