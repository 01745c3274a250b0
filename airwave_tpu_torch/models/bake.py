"""Offline bake: render whole signals on the device, block by block.

Port of airwave_tpu/models/bake.py. The input is moved to the device once,
a Python loop over blocks (or M-block steps) takes the place of lax.scan,
and the output is fetched once at the end. Page rotation is tuple renaming,
so the loop copies no pages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from airwave_tpu_torch.device import (DEFAULT_DEVICE, apply_precision_policy,
                                      resolve_device)
from airwave_tpu_torch.models.binaural import BinauralChain, ChainState
from airwave_tpu_torch.ops import eq_block, upols


def bake(
    hrir: np.ndarray,
    x: np.ndarray,
    sample_rate: float,
    eq_coefficients=None,
    eq_preamp: float = 1.0,
    block_size: int = 512,
    state: Optional[ChainState] = None,
    pad_to_pow2: bool = False,
    blocks_per_step: int = 1,
    device: "torch.device | str" = DEFAULT_DEVICE,
) -> Tuple[np.ndarray, ChainState]:
    """Render [B, S, n] through HRIRs [S, 2, L] (+ optional EQ) on `device`
    (the card by default; pass device="cpu" for the CPU).

    Returns (y [B, 2, n] float32 numpy, final ChainState on the device); the
    state seeds a continuation bake. The single-block step writes the delay
    line in place (upols.conv_step), so bake copies a passed-in `state`
    once before stepping: the caller's state is left as it was and may seed
    another bake (for example a retry). The paged step is functional.

    blocks_per_step=M > 1 renders M blocks per delay-line read (the paged
    lookahead path) with the same output to f32 tolerance. A continuation
    `state` must come from a bake with the same blocks_per_step (the carries
    differ)."""
    device = resolve_device(device)
    apply_precision_policy()
    x = np.asarray(x, np.float32)
    B, S, n = x.shape
    T = block_size
    M = int(blocks_per_step)
    stride = T * M
    padded = ((n + stride - 1) // stride) * stride
    if padded != n:
        x = np.concatenate(
            [x, np.zeros((B, S, padded - n), np.float32)], axis=-1
        )
    N = padded // stride

    with torch.inference_mode():
        conv_params = upols.make_conv_params(hrir, T, pad_to_pow2=pad_to_pow2,
                                             lookahead=M, device=device)
        eq_enabled = eq_coefficients is not None
        if eq_enabled:
            eq_params = eq_block.make_eq_params(eq_coefficients, eq_preamp, T,
                                                device=device)
        else:
            eq_params = eq_block.unity_eq_params(T, device=device)
        transition_length = max(1, int(round(sample_rate * 0.020)))
        chain = BinauralChain(conv_params, eq_params, eq_params,
                              transition_length, T, blocks_per_step=M,
                              eq_enabled=eq_enabled)
        if state is None:
            P2 = conv_params.partition_count
            conv = (upols.make_conv_state_paged(B, S, P2, T, M, device)
                    if M > 1 else upols.make_conv_state(B, S, P2, T, device))
            state = ChainState(conv=conv,
                               eq=eq_block.make_eq_state(B, device=device))
        elif isinstance(state.conv, upols.ConvState):
            # conv_step writes the delay line in place: copy it once here so
            # the caller's state is not consumed. The paged step is functional.
            state = state._replace(conv=state.conv._replace(
                fdl=state.conv.fdl.clone()))

        xs = torch.from_numpy(x).to(device).view(B, S, N, M, T)
        y = torch.empty((B, 2, N, M, T), device=device)
        for i in range(N):
            if M > 1:
                state, ys = chain(state, xs[:, :, i])           # [B, M, 2, T]
                y[:, :, i] = ys.transpose(1, 2)
            else:
                state, ys = chain(state, xs[:, :, i, 0])        # [B, 2, T]
                y[:, :, i, 0] = ys
        out = y.view(B, 2, padded)[:, :, :n].cpu().numpy()
    return out, state
