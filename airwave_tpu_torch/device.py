"""Device resolution and the strict fp32 precision policy.

Every entry point and builder of the port takes `device`, and its default
is the card (DEFAULT_DEVICE, `cuda:0`): the CPU runs only where a caller
passes device="cpu", as the tests do. Asking for the card where there is
none raises; nothing falls back to the CPU.

The 1e-5 chain contract (BASELINE.md) needs every signal-bearing matmul in
IEEE fp32. On a Hopper card PyTorch may route fp32 products through TF32
tensor cores (about three decimal digits), so the entry points switch that
off — the counterpart of the JAX package's Precision.HIGHEST. The relaxed
tiers (AIRWAVE_MATMUL_PRECISION=high or default, ops/precision) run their
own bf16 products and leave this policy strict.
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda:0"


def resolve_device(device: "torch.device | str" = DEFAULT_DEVICE) -> torch.device:
    """An explicit torch.device with its index (`cuda` becomes the current
    card, `cuda:N`). Asking for CUDA where there is none raises: the port
    never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False (pass device='cpu' to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


def apply_precision_policy() -> None:
    """Strict fp32: no TF32 in matmuls or cuDNN, highest matmul precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def precision_is_strict() -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def precision_stamp() -> dict:
    """The fields a result line carries under a relaxed tier, the rule of
    bench.py:_emit: nothing at AIRWAVE_MATMUL_PRECISION=highest (the
    default); otherwise the tier, accuracy_contract false, and
    accuracy_contract_1e4 true for "high" (the relaxed 1e-4 tier) only."""
    prec = os.environ.get("AIRWAVE_MATMUL_PRECISION", "highest").lower()
    if prec == "highest":
        return {}
    return {"matmul_precision": prec, "accuracy_contract": False,
            "accuracy_contract_1e4": prec == "high"}
