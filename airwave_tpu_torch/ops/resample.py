"""Resampling: the linear-interpolation parity path and the polyphase FIR
quality path.

Port of airwave_tpu/ops/resample.py. The reference resamples HRIRs offline
with a vDSP control-vector gather (Airwave/Resampler.swift:31-68): output[i]
interpolates the input at fractional index i * (from/to), identity when the
rates differ by < 0.01 Hz, output length floor(n / stride).
`resample_linear` reproduces that contract (host numpy; the renderer's
default). `resample_polyphase` is the quality alternative, a Kaiser-windowed
sinc polyphase FIR (host numpy, float64), and `resample_polyphase_device`
its batched torch form on a device: one gather of input windows and one
contraction against each output's phase bank. Both polyphase functions are
validation paths: their callers are tests and scripts.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from airwave_tpu_torch.device import (DEFAULT_DEVICE, apply_precision_policy,
                                      resolve_device)

IDENTITY_EPSILON_HZ = 0.01


def resample_linear(x: np.ndarray, from_rate: float, to_rate: float) -> np.ndarray:
    """vDSP_vgenp-equivalent linear-interp gather along the last axis."""
    if abs(from_rate - to_rate) < IDENTITY_EPSILON_HZ:
        return np.asarray(x)
    x = np.asarray(x)
    n = x.shape[-1]
    stride = from_rate / to_rate
    out_count = int(n / stride)
    if out_count <= 0:
        return x[..., :0]
    # Control vector built in float32 like vDSP_vramp (Resampler.swift:56).
    control = (np.float32(0) + np.arange(out_count, dtype=np.float32)
               * np.float32(stride)).astype(np.float64)
    idx = np.floor(control).astype(np.int64)
    frac = control - idx
    idx0 = np.clip(idx, 0, n - 1)
    idx1 = np.clip(idx + 1, 0, n - 1)
    return (
        x[..., idx0] * (1.0 - frac) + x[..., idx1] * frac
    ).astype(x.dtype)


def _kaiser_beta(att_db: float) -> float:
    if att_db > 50:
        return 0.1102 * (att_db - 8.7)
    if att_db >= 21:
        return 0.5842 * (att_db - 21) ** 0.4 + 0.07886 * (att_db - 21)
    return 0.0


def design_polyphase(
    from_rate: float,
    to_rate: float,
    taps_per_phase: int = 32,
    att_db: float = 90.0,
    max_denominator: int = 1000,
):
    """A polyphase resampling filter bank: (up, down, bank [up,
    taps_per_phase] float64) for rational up/down resampling with a
    Kaiser-windowed sinc lowpass at min(from, to)/2."""
    frac = Fraction(to_rate / from_rate).limit_denominator(max_denominator)
    up, down = frac.numerator, frac.denominator
    cutoff = min(1.0 / down, 1.0 / up)  # relative to up-sampled Nyquist
    ntaps = taps_per_phase * up
    beta = _kaiser_beta(att_db)
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(ntaps, beta)
    h *= up / np.sum(h)
    bank = h.reshape(taps_per_phase, up).T.copy()  # [up, taps]
    return up, down, bank.astype(np.float64)


def _windows(n: int, from_rate: float, to_rate: float, taps_per_phase: int):
    """(clipped window indices [out, taps], valid [out, taps], per-output
    phase banks [out, taps] float64) of the polyphase gather: output m
    draws from up-sampled index m*down, phase m*down % up, base input
    index m*down // up, a window centred on it."""
    up, down, bank = design_polyphase(from_rate, to_rate, taps_per_phase)
    out_count = int(n * to_rate / from_rate)
    taps = bank.shape[1]
    m = np.arange(out_count)
    phase = (m * down) % up
    base = (m * down) // up
    idx = base[:, None] - np.arange(taps)[None, :] + taps // 2
    valid = (idx >= 0) & (idx < n)
    return np.clip(idx, 0, n - 1), valid, bank[phase]


def resample_polyphase_device(
    x, from_rate: float, to_rate: float, taps_per_phase: int = 32,
    device: "torch.device | str" = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Rational polyphase FIR resampling on `device` (the card by default),
    float32, batched over leading axes: input windows [..., out, taps]
    contracted with each output's phase bank [out, taps] -> [..., out]. The
    bank is designed on the host in float64."""
    device = resolve_device(device)
    apply_precision_policy()
    x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x).to(device, torch.float32)
    if abs(from_rate - to_rate) < IDENTITY_EPSILON_HZ:
        return x
    idx, valid, weights = _windows(x.shape[-1], from_rate, to_rate,
                                   taps_per_phase)
    w = torch.tensor(weights * valid, dtype=torch.float32, device=device)
    windows = x[..., torch.from_numpy(idx).to(device)]       # [..., out, taps]
    return torch.einsum("...ot,ot->...o", windows, w)


def resample_polyphase(
    x: np.ndarray, from_rate: float, to_rate: float, taps_per_phase: int = 32
) -> np.ndarray:
    """Rational polyphase FIR resampling along the last axis (host numpy,
    float64 arithmetic, float32 out); resample_polyphase_device is the
    batched torch form."""
    if abs(from_rate - to_rate) < IDENTITY_EPSILON_HZ:
        return np.asarray(x)
    x = np.asarray(x, np.float64)
    idx, valid, weights = _windows(x.shape[-1], from_rate, to_rate,
                                   taps_per_phase)
    windows = np.where(valid, x[..., idx], 0.0)  # [..., out, taps]
    y = np.einsum("...ot,ot->...o", windows, weights)
    return y.astype(np.float32)
