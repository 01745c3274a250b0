"""HRIR resampling on the host: the linear-interpolation parity path.

Port of airwave_tpu/ops/resample.py:resample_linear, the renderer's default
resampler. The reference resamples HRIRs offline with a vDSP control-vector
gather (Airwave/Resampler.swift:31-68): output[i] interpolates the input at
fractional index i * (from/to), identity when the rates differ by < 0.01 Hz,
output length floor(n / stride). Host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

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
