"""Scan biquad cascade: the validation path of the EQ (PyTorch).

Port of airwave_tpu/ops/biquad_scan.py. The DF2T recurrence
s[n] = A s[n-1] + B x[n] (constant A, B per filter, from
biquad_design.biquad_state_space) is a first-order affine recurrence, so the
time axis runs as a log-depth scan over elements (A_prod, b) composing as

    (A2, b2) o (A1, b1) = (A2 @ A1, A2 @ b1 + b2)

here a Hillis-Steele scan (log2(T) doubling steps; the JAX version's
associative_scan takes another tree, so the f32 sums differ in rounding),
any block length, float32 or float64. The cascade is a loop over the
padded filter axis; inactive (padding) filters pass the signal through
exactly.

Validation only: the device EQ is ops/eq_block's block state-space
lowering. This path checks it in float64 and at odd block lengths.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from airwave_tpu_torch.device import (DEFAULT_DEVICE, apply_precision_policy,
                                      resolve_device)
from airwave_tpu_torch.ops import biquad_design as bd

MAX_FILTERS = 64


class ScanEqParams(NamedTuple):
    # Per-filter DF2T pieces, padded to MAX_FILTERS with identity filters.
    A: torch.Tensor        # [F, 2, 2]
    Bv: torch.Tensor       # [F, 2]
    b0: torch.Tensor       # [F]
    active: torch.Tensor   # [F] float (1.0 = real filter)
    preamp: torch.Tensor   # [] linear gain


def make_scan_params(
    coefficients: Sequence[bd.BiquadCoefficients],
    preamp_linear: float,
    dtype: torch.dtype = torch.float32,
    max_filters: int = MAX_FILTERS,
    device: "torch.device | str" = DEFAULT_DEVICE,
) -> ScanEqParams:
    count = len(coefficients)
    if count > max_filters:
        raise ValueError(f"{count} filters exceed max_filters={max_filters}")
    A = np.zeros((max_filters, 2, 2), np.float64)
    Bv = np.zeros((max_filters, 2), np.float64)
    b0 = np.ones(max_filters, np.float64)
    active = np.zeros(max_filters, np.float64)
    for i, c in enumerate(coefficients):
        Ai, Bi, _Ci, Di = bd.biquad_state_space(c)
        A[i], Bv[i], b0[i], active[i] = Ai, Bi, Di, 1.0
    device = resolve_device(device)
    apply_precision_policy()

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return ScanEqParams(A=tensor(A), Bv=tensor(Bv), b0=tensor(b0),
                        active=tensor(active), preamp=tensor(preamp_linear))


def make_scan_state(batch: int, channels: int = 2,
                    max_filters: int = MAX_FILTERS,
                    dtype: torch.dtype = torch.float32,
                    device: "torch.device | str" = DEFAULT_DEVICE
                    ) -> torch.Tensor:
    """State z [B, C, F, 2]."""
    return torch.zeros((batch, channels, max_filters, 2), dtype=dtype,
                       device=resolve_device(device))


def _one_filter(x: torch.Tensor, s0: torch.Tensor, A: torch.Tensor,
                Bv: torch.Tensor, b0: torch.Tensor):
    """One biquad over the whole block by scan.

    x [..., T]; s0 [..., 2]; returns (y [..., T], s_T [..., 2])."""
    T = x.shape[-1]
    # Elements (A_t, b_t) = (A, Bv * x_t). A is the same for every lane, so
    # its running products are [T, 2, 2] and only b carries the batch.
    A_cum = A.expand(T, 2, 2).clone()
    b_cum = x[..., :, None] * Bv                        # [..., T, 2]
    shift = 1
    while shift < T:
        # Element t composes with element t - shift (inclusive scan).
        right = A_cum[shift:]
        b_next = b_cum.clone()
        b_next[..., shift:, :] = (
            torch.einsum("tij,...tj->...ti", right, b_cum[..., :-shift, :])
            + b_cum[..., shift:, :])
        A_next = A_cum.clone()
        A_next[shift:] = torch.einsum("tij,tjk->tik", right, A_cum[:-shift])
        A_cum, b_cum = A_next, b_next
        shift *= 2
    # s[t] = A_cum[t] @ s0 + b_cum[t]  (state AFTER sample t)
    s_t = torch.einsum("tij,...j->...ti", A_cum, s0) + b_cum
    # y[t] = b0 x[t] + z1[t-1]; z1[t-1] = s[t-1][0] (s0 for t=0).
    z1_prev = torch.cat([s0[..., None, 0], s_t[..., :-1, 0]], dim=-1)
    y = b0 * x + z1_prev
    return y, s_t[..., -1, :]


def eq_scan_block(params: ScanEqParams, state: torch.Tensor,
                  x: torch.Tensor):
    """Full cascade over one block: x [B, C, T] -> (state', y [B, C, T]).

    Sequential over the (padded) filter axis; inactive filters pass the
    signal (and their state) through untouched."""
    signal = x * params.preamp
    states = []
    for f in range(params.A.shape[0]):
        s0 = state[:, :, f]
        act = params.active[f]
        y, s_t = _one_filter(signal, s0, params.A[f], params.Bv[f],
                             params.b0[f])
        signal = act * y + (1.0 - act) * signal
        states.append(act * s_t + (1.0 - act) * s0)
    return torch.stack(states, dim=2), signal
