"""Real DFTs as fp32 matmuls against precomputed weights (float planes).

Port of the direct transforms of airwave_tpu/ops/fftmm.py. For the fixed
block sizes of this framework the DFT is a dense matrix, and the (re, im)
planes it returns are exactly the storage format of the delay line
(ops/upols), so no complex dtype appears anywhere. The synthesis weights can
produce a window of the output only: overlap-save keeps the second half of
each inverse transform.

The products run in strict fp32 (device.apply_precision_policy) unless
AIRWAVE_MATMUL_PRECISION or AIRWAVE_DFT_PRECISION names a relaxed tier
(ops/precision): TF32 would cost the 1e-5 chain contract.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.ops import precision

# The tier of the numerics-bearing products (ops/precision): "highest"
# (IEEE fp32, the default) holds the 1e-5 chain contract, "high" (bf16x3)
# the relaxed 1e-4 one, "default" (one bf16 pass) none.
# AIRWAVE_DFT_PRECISION sets the DFT products (analysis and synthesis)
# alone and follows AIRWAVE_MATMUL_PRECISION when unset. Read at import.
PRECISION = precision.resolve("AIRWAVE_MATMUL_PRECISION")
DFT_PRECISION = precision.resolve("AIRWAVE_DFT_PRECISION", PRECISION)


@functools.lru_cache(maxsize=16)
def _rfft_weights_np(n: int) -> np.ndarray:
    """[n, K, 2] f32 with X[k] = sum_t x[t] * (cos - i sin)(2 pi t k / n)."""
    k = n // 2 + 1
    t = np.arange(n)[:, None]
    freqs = np.arange(k)[None, :]
    angle = -2.0 * np.pi * t * freqs / n
    return np.stack([np.cos(angle), np.sin(angle)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _irfft_weights_np(n: int, start: int, length: int) -> np.ndarray:
    """[K, 2, length] f32 synthesizing x[start:start+length] from packed-full
    rfft planes: x[t] = (1/n) * sum_k w_k * (re_k cos + (-im_k) sin)."""
    k = n // 2 + 1
    t = np.arange(start, start + length)[None, :]
    freqs = np.arange(k)[:, None]
    angle = 2.0 * np.pi * freqs * t / n
    scale = np.full((k, 1), 2.0 / n)
    scale[0] = 1.0 / n
    if n % 2 == 0:
        scale[-1] = 1.0 / n
    re = scale * np.cos(angle)
    im = -scale * np.sin(angle)
    return np.stack([re, im], axis=1).astype(np.float32)


def rfft_weights_half(n: int,
                      device: "torch.device | str" = DEFAULT_DEVICE) -> torch.Tensor:
    """First n//2 rows of the n-point analysis weights [n//2, K, 2]: the
    half-window transform u = W1 @ b of the UPOLS delay line (ops/upols)."""
    return torch.tensor(_rfft_weights_np(n)[: n // 2],
                        device=resolve_device(device))


def irfft_weights(n: int, start: int, length: int,
                  device: "torch.device | str" = DEFAULT_DEVICE) -> torch.Tensor:
    """[K, 2, length] synthesis weights of x[start:start+length]."""
    return torch.tensor(_irfft_weights_np(n, start, length),
                        device=resolve_device(device))


def rfft_mm(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """x [..., n] f32 -> packed planes [..., K, 2] via one matmul at
    DFT_PRECISION."""
    n, k, c = weights.shape
    return precision.matmul(x, weights.reshape(n, k * c), DFT_PRECISION,
                            b_key=weights).unflatten(-1, (k, c))


def irfft_mm(planes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Planes [..., K, 2] -> samples [..., length] via one matmul at
    DFT_PRECISION."""
    k, c, length = weights.shape
    return precision.matmul(planes.flatten(-2), weights.reshape(k * c, length),
                            DFT_PRECISION, b_key=weights)
