"""Matmul precision tiers of the DFT and EQ products: bf16x3 and one bf16
pass on the card's tensor cores, beside the strict IEEE fp32 default.

Port of the JAX package's knobs AIRWAVE_MATMUL_PRECISION,
AIRWAVE_DFT_PRECISION and AIRWAVE_MAC_PRECISION
(airwave_tpu/ops/fftmm.py:36-52, upols.py:56-60 and :143-148,
eq_block.py:37-41). Each module resolves its variables once, at import,
into a tier name:

  highest  IEEE fp32, the torch call each site always made (the default;
           the strict 1e-5 chain contract).
  high     bf16x3, the TPU's Precision.HIGH: a = a_hi + a_lo and
           b = b_hi + b_lo with every part in bf16, and
           a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, accumulated and
           returned in fp32 (a residual near 2^-16; the relaxed 1e-4
           contract).
  default  one bf16 pass a_hi·b_hi with fp32 accumulation and output, the
           TPU's Precision.DEFAULT (a measurement mode: no contract).

A relaxed product is one product over K-stacked operands,
[a_lo | a_hi | a_hi] · [b_hi ; b_lo ; b_hi] (one pass: a_hi · b_hi), on
bf16 operands with fp32 accumulation and fp32 output:
torch.mm/bmm(..., out_dtype=torch.float32) on the card. The two small
products come first in K: the tensor cores align each k-step's products
to the accumulator and truncate, so the accumulator holds only their small
sum while they are added (with a_hi·b_hi first, the route sat 2.6e-6 and
5.2e-6 rel-RMS from its plain version at the headline's analysis and
synthesis shapes on the H100, against 4.4e-7 and 9.1e-7 for one pass).
No product has a bf16 output, which would round the result at 2^-9. The
process-wide TF32
and float32-matmul-precision flags are not touched: device.py keeps them
strict for every other matmul and every thread.

A weight operand is split once and cached on the weight tensor the site
names (weights are never written in place: a bank swap or an EQ retarget
builds new tensors); an activation is split on every call. On a CPU
tensor `product` runs the plain version, the same operands in fp32: the
card's result up to summation order and the tensor cores' truncating
accumulation (the product of two bf16 values is exact in fp32).
"""

from __future__ import annotations

import os

import torch
from torch.utils.weak import WeakIdKeyDictionary

from airwave_tpu_torch.utils.profiling import BUILD_WEIGHT_OPERAND, span

TIERS = ("highest", "high", "default")
_PARTS = {"high": 3, "default": 1}

# weight tensor -> {(side, tier, view shape, strides, offset): operand}
_WEIGHT_OPERANDS = WeakIdKeyDictionary()
_launches = 0


def resolve(variable: str, fallback: "str | None" = None) -> str:
    """The tier that environment variable `variable` names, in any case.

    Without `fallback` it defaults to "highest"; with one, unset or empty
    follows `fallback` (as AIRWAVE_DFT_PRECISION and AIRWAVE_MAC_PRECISION
    follow AIRWAVE_MATMUL_PRECISION). Any other value raises KeyError, as
    the JAX package's dict lookups do."""
    raw = os.environ.get(variable, "highest" if fallback is None else "")
    raw = raw.lower()
    if fallback is not None and raw == "":
        return fallback
    if raw not in TIERS:
        raise KeyError(f"{variable}={raw!r}: expected one of {TIERS}")
    return raw


def launch_count() -> int:
    """Relaxed products run on the card since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def operand(t: torch.Tensor, side: str, tier: str,
            key: "torch.Tensor | None" = None) -> torch.Tensor:
    """`t` as the contiguous bf16 operand of a relaxed product, K-stacked
    along its contraction axis (the last for the left operand, side "a";
    the second to last for the right one, side "b"): [lo | hi | hi] for
    "a" and [hi ; lo ; hi] for "b" at "high", the bf16 rounding hi alone
    at "default". hi = bf16(t), lo = bf16(t - hi).

    With `key`, the weight tensor that `t` is a view of, the operand is
    built once and cached on `key` for as long as it lives."""
    if key is not None:
        views = _WEIGHT_OPERANDS.setdefault(key, {})
        tag = (side, tier, tuple(t.shape), t.stride(), t.storage_offset())
        if tag not in views:
            with span(BUILD_WEIGHT_OPERAND):
                views[tag] = operand(t, side, tier)
        return views[tag]
    dim = t.dim() - (1 if side == "a" else 2)
    n = t.shape[dim]
    parts = _PARTS[tier]
    shape = list(t.shape)
    shape[dim] = parts * n
    out = torch.empty(shape, dtype=torch.bfloat16, device=t.device)
    if parts == 1:
        return out.copy_(t)
    lo_at, hi_at, again_at = (0, 1, 2) if side == "a" else (1, 0, 2)
    hi = out.narrow(dim, hi_at * n, n)
    hi.copy_(t)
    torch.sub(t, hi, out=out.narrow(dim, lo_at * n, n))
    out.narrow(dim, again_at * n, n).copy_(hi)
    return out


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two operands, accumulated and returned in fp32: a
    [..., M, K] with b [K, N], or a [M, K] with b [..., K, N] (a broadcast
    over b's leading axes). On the card one torch.mm/bmm with
    out_dtype=torch.float32 on the bf16 tensor cores; on a CPU tensor the
    plain version."""
    global _launches
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    _launches += 1
    if b.dim() == 2:
        rows = a.reshape(-1, a.shape[-1])
        return torch.mm(rows, b, out_dtype=torch.float32).view(
            *a.shape[:-1], b.shape[-1])
    if a.dim() != 2:
        raise ValueError(f"product: a {tuple(a.shape)} and b {tuple(b.shape)}"
                         f" are both batched")
    mats = b.reshape(-1, *b.shape[-2:])
    y = torch.bmm(a.expand(mats.shape[0], -1, -1), mats,
                  out_dtype=torch.float32)
    return y.view(*b.shape[:-2], a.shape[0], b.shape[-1])


def matmul(a: torch.Tensor, b: torch.Tensor, tier: str,
           a_key: "torch.Tensor | None" = None,
           b_key: "torch.Tensor | None" = None) -> torch.Tensor:
    """torch.matmul(a, b) at `tier`, for a [..., M, K] with a 2-D b or a
    2-D a with b [..., K, N]. At "highest" it is torch.matmul itself: no
    split and no cache. `a_key` or `b_key` marks that operand as a weight,
    a view of the key tensor, split once."""
    if tier == "highest":
        return torch.matmul(a, b)
    return product(operand(a, "a", tier, key=a_key),
                   operand(b, "b", tier, key=b_key))
