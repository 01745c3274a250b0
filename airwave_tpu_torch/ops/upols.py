"""Batched uniform partitioned overlap-save convolution (PyTorch).

Port of airwave_tpu/ops/upols.py. One step convolves a whole batch of
streams, every virtual speaker and both ears at once:

    state:  fdl [Kp, S, P2, 2, B] f32     delay line of HALF-window analysis
                                          spectra u_t = W1 @ b_t (re/im
                                          planes, batch minor)
            write_pos int                 circular write cursor (host int)
    params: Gflip2 [S, E, 2*P2, K, 2]     half-window filter bank per ear,
                                          partition-flipped and doubled so
                                          the per-block rotation is a slice

The overlap-save window [b_{t-1}, b_t] satisfies X_t = u_{t-1} + s ⊙ u_t
with s_k = (-1)^k, so the UPOLS sum over full-window spectra collapses onto
the u history against G_q = H_{q-1} + s⊙H_q (_half_window_bank): the
analysis contracts T samples instead of 2T and no overlap block is carried.
The delay line is written in place, one slot per block, and the filter bank
is rotated instead of the line: the MAC kernel reads the rotated window of
the doubled bank where it lies.

The carry layouts are the reference's, so states move between the two
packages unchanged (interop.py). Unlike the reference, which is functional,
conv_step writes the single-block delay line IN PLACE and the lane rolls
(conv_roll_lanes, conv_roll_lanes_paged) write the lanes they fix in place:
the state passed to them is consumed, and the returned state holds the same
tensors. The serving pool owns its carry and relies on that: the kernel's
delay-line operand stays the one contiguous buffer.

Everything derived from the params alone (the MAC's filter operands, the
padded and folded synthesis weights) is built by single_block_bank,
paged_bank and project_weights; callers that step many times build those
once and pass them in, since eager PyTorch does not hoist loop invariants.

The analysis and synthesis products run at fftmm.DFT_PRECISION (ops/
precision: IEEE fp32 by default, bf16x3 or one bf16 pass when asked). The
MAC is the mac_kmajor kernels in fp32 under every tier.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from airwave_tpu_torch.kernels.mac_kmajor import (mac_kmajor, mac_kmajor_pages,
                                                  max_columns)
from airwave_tpu_torch.ops import fftmm, precision
from airwave_tpu_torch.utils.profiling import (CONV_ANALYSIS, CONV_SYNTHESIS,
                                               span)

# The JAX package's tier names (ops/precision). The DFT products read
# fftmm.DFT_PRECISION. _MAC_PRECISION (AIRWAVE_MAC_PRECISION, following
# AIRWAVE_MATMUL_PRECISION) is parsed, so that a bad value raises as it does
# there, and governs nothing: the JAX package applies it to its dot and
# einsum MAC lowerings only, and the port's MAC is always the mac_kmajor
# kernels, which run in fp32 under every tier (the Pallas kernel's "true-f32
# VPU precision", AIRWAVE_MAC_IMPL=pallas). Read at import.
PRECISION = precision.resolve("AIRWAVE_MATMUL_PRECISION")
_MAC_PRECISION = precision.resolve("AIRWAVE_MAC_PRECISION", PRECISION)


class ConvParams(NamedTuple):
    # Gflip2[..., j, :, :] with j in [start, start+P2) yields
    # G[(write_pos - j) % P2]; float planes with a trailing (re, im) axis.
    Gflip2: torch.Tensor  # [S, E, 2*P2, K, 2] float32
    wf: torch.Tensor      # [T, K, 2] half-window analysis weights
    wi: torch.Tensor      # [K, 2, T] second-half synthesis weights

    @property
    def num_speakers(self) -> int:
        return self.Gflip2.shape[-5]

    @property
    def num_ears(self) -> int:
        return self.Gflip2.shape[-4]

    @property
    def partition_count(self) -> int:
        return self.Gflip2.shape[-3] // 2

    @property
    def num_bins(self) -> int:
        return self.Gflip2.shape[-2]


class ConvState(NamedTuple):
    fdl: torch.Tensor  # [Kp, S, P2, 2, B] float32, batch minor
    write_pos: int


class PagedConvState(NamedTuple):
    """Delay line as P2/M pages of M slots each (pages[0] newest). Rotation
    is tuple renaming and the new page is the analysis product itself, so
    the line is never copied or rewritten. Slots hold half-window spectra,
    so the pages are the whole convolution state."""

    pages: tuple  # each [Kp, S, 2, M, B] float32, newest first


def _half_window_bank(H: np.ndarray) -> np.ndarray:
    """Fold the overlap-save window recombination into the filter bank:

        sum_{p=0}^{P-1} H_p X_{t-p} = sum_{q=0}^{P} G_q u_{t-q},
        G_0 = s⊙H_0,   G_q = H_{q-1} + s⊙H_q,   G_P = H_{P-1}.

    H: [S, E, P, K] complex -> [S, E, P+1, K], in f64."""
    K = H.shape[-1]
    s = ((-1.0) ** np.arange(K))[None, None, None, :]
    z = np.zeros_like(H[:, :, :1])
    return np.concatenate([z, H], axis=2) + s * np.concatenate([H, z], axis=2)


def make_conv_params(hrir: np.ndarray, block_size: int,
                     pad_to_pow2: bool = True,
                     lookahead: int = 1,
                     partitions: "int | None" = None,
                     device: "torch.device | str" = DEFAULT_DEVICE) -> ConvParams:
    """Build ConvParams from time-domain HRIRs [S, E, L].

    A P-partition HRIR yields P+1 half-window coefficients. pad_to_pow2
    buckets the real partition count to a power of two (shape stability
    across preset swaps); lookahead=M adds M-1 zero tail partitions and
    rounds up to whole pages for conv_step_paged; partitions=N forces the
    stored count (it must cover the bank and, with lookahead, divide by M)."""
    hrir = np.asarray(hrir, np.float32)
    length = hrir.shape[-1]
    real_p = max(1, math.ceil(length / block_size))
    lead = hrir.shape[:-1]
    padded = np.zeros(lead + (real_p * block_size,), np.float64)
    padded[..., :length] = hrir
    parts = padded.reshape(lead + (real_p, block_size))
    parts = np.concatenate([parts, np.zeros_like(parts)], axis=-1)
    H = np.fft.rfft(parts, axis=-1)            # [S, E, P, K] complex128
    G = _half_window_bank(H)                   # [S, E, P+1, K]
    base = G.shape[2]
    need = base
    if lookahead > 1:
        if pad_to_pow2:
            need = (1 << (real_p - 1).bit_length()) + 1
        need += lookahead - 1
        need += (-need) % lookahead
    elif pad_to_pow2:
        need = (1 << (real_p - 1).bit_length()) + 1
    if partitions is not None:
        partitions = int(partitions)
        if partitions < need:
            raise ValueError(
                f"partitions={partitions} cannot hold this HRIR: needs "
                f">= {need} (length {length} at block {block_size}, "
                f"lookahead {lookahead}; half-window bank = partitions + 1)"
            )
        if lookahead > 1 and partitions % lookahead:
            raise ValueError(
                f"partitions={partitions} is not divisible by "
                f"lookahead={lookahead}"
            )
        need = partitions
    if need > base:
        G = np.concatenate(
            [G, np.zeros(G.shape[:2] + (need - base,) + G.shape[3:],
                         G.dtype)],
            axis=2,
        )
    Gflip = G[:, :, ::-1, :]
    Gflip2 = np.concatenate([Gflip, Gflip], axis=2)  # [S, E, 2*P2, K]
    planes = np.stack([Gflip2.real, Gflip2.imag], axis=-1).astype(np.float32)
    n = 2 * block_size
    device = resolve_device(device)
    return ConvParams(
        Gflip2=torch.tensor(planes, device=device),
        wf=fftmm.rfft_weights_half(n, device),
        wi=fftmm.irfft_weights(n, block_size, block_size, device),
    )


def padded_bin_count(block_size: int) -> int:
    """Delay-line bin rows: K = block+1 padded up to a multiple of 8. Pad
    rows hold zeros against zero filter weights and contribute nothing."""
    k = block_size + 1
    return k + (-k) % 8


def make_conv_state(batch: int, num_speakers: int, partition_count: int,
                    block_size: int,
                    device: "torch.device | str" = DEFAULT_DEVICE) -> ConvState:
    return ConvState(
        fdl=torch.zeros((padded_bin_count(block_size), num_speakers,
                         partition_count, 2, batch),
                        device=resolve_device(device)),
        write_pos=0,
    )


def make_conv_state_paged(batch: int, num_speakers: int, partition_count: int,
                          block_size: int, lookahead: int,
                          device: "torch.device | str" = DEFAULT_DEVICE
                          ) -> PagedConvState:
    if partition_count % lookahead:
        raise ValueError(f"partition_count={partition_count} is not "
                         f"divisible by lookahead={lookahead}")
    shape = (padded_bin_count(block_size), num_speakers, 2, lookahead, batch)
    device = resolve_device(device)
    return PagedConvState(
        pages=tuple(torch.zeros(shape, device=device)
                    for _ in range(partition_count // lookahead)),
    )


def conv_reset(state: ConvState,
               stream_mask: "torch.Tensor | None" = None) -> ConvState:
    """Zero conv history (write_pos to 0); with a [B] bool mask only the
    masked streams (write_pos kept). Either way written in place into the
    delay line passed in (as conv_step writes it): a pool at capacity has no
    room for a second delay line. A caller that must keep the old history
    copies it first (StreamPool.snapshot does)."""
    with torch.inference_mode():  # the carry may be an inference tensor
        if stream_mask is None:
            return ConvState(fdl=state.fdl.zero_(), write_pos=0)
        m = stream_mask.to(torch.bool)
        return ConvState(fdl=state.fdl.masked_fill_(m, 0.0),
                         write_pos=state.write_pos)


def conv_reset_paged(state: PagedConvState,
                     stream_mask: "torch.Tensor | None" = None
                     ) -> PagedConvState:
    """Zero paged conv history; with a [B] bool mask only the masked
    streams (a zeroed lane is rotation-invariant), in place as conv_reset."""
    with torch.inference_mode():
        if stream_mask is None:
            return PagedConvState(
                pages=tuple(pg.zero_() for pg in state.pages))
        m = stream_mask.to(torch.bool)
        return PagedConvState(
            pages=tuple(pg.masked_fill_(m, 0.0) for pg in state.pages))


# --- Filter operands (params-derived, built once per bank) ------------------


def _complex_block(h: torch.Tensor, k_padded: int) -> torch.Tensor:
    """Bank planes [..., K, 2] -> [..., Kp, C, Q]: the real 2x2 form of the
    complex product, (re, im)_q = sum_c f_c * h2[c, q], with zero pad bins."""
    hre, him = h[..., 0], h[..., 1]
    h2 = torch.stack(
        [torch.stack([hre, him], dim=-1), torch.stack([-him, hre], dim=-1)],
        dim=-2,
    )
    return F.pad(h2, (0, 0, 0, 0, 0, k_padded - h.shape[-2]))


def single_block_bank(params: ConvParams, k_padded: int) -> torch.Tensor:
    """The single-block MAC operand for every rotation: [Kp, E*Q, S, 2*P2, C].

    Rotation w is _rotated_window(bank, w): a slice of the doubled
    partition axis, which the kernel reads in place as its h [Kp, O=(E,Q),
    R=(S,P,C)]."""
    h2 = _complex_block(params.Gflip2, k_padded)   # [S, E, 2P2, Kp, C, Q]
    S, E, P, Kp, C, Q = h2.shape
    return h2.permute(3, 1, 5, 0, 2, 4).reshape(Kp, E * Q, S, P, C)


def _rotated_window(bank: torch.Tensor, write_pos: int) -> torch.Tensor:
    """Filter operand of the block at cursor w, as it lies in the doubled
    bank: a [Kp, O, S, P2, C] view whose slot j multiplies the block from
    (w - j) blocks ago, G[(w - j) % P2] = Gflip2[(P2 - 1 - w) + j]. The
    kernel reads it through its strides (each (P2, C) run is contiguous),
    so a step makes no copy of it."""
    P2 = bank.shape[3] // 2
    return bank.narrow(3, P2 - 1 - write_pos, P2)


def _rotated_operand(bank: torch.Tensor, write_pos: int) -> torch.Tensor:
    """The rotated window as a contiguous [Kp, O, S*P2*C] copy: with one
    speaker the reshape of the slice alone would be a strided view."""
    Kp, O = bank.shape[:2]
    return _rotated_window(bank, write_pos).reshape(Kp, O, -1).contiguous()


def paged_bank(params: ConvParams, lookahead: int,
               k_padded: int) -> torch.Tensor:
    """Per-page MAC operands of the paged step, [n_pages, Kp, O, R] with
    O = (m, e, q) = M*E*2 output columns and R = (s, c, j) = S*2*M rows.

    Page a, in-page slot j holds block t+M-1-j-a*M, so output m's
    coefficient against it is Hz[m+j+a*M] with Hz the natural-order bank
    behind M-1 zero partitions."""
    M = lookahead
    P2 = params.partition_count
    h_nat = params.Gflip2[:, :, :P2].flip(2)               # [S, E, P2, K, 2]
    h2 = _complex_block(h_nat, k_padded)                   # [S, E, P2, Kp, C, Q]
    h2 = F.pad(h2, (0, 0, 0, 0, 0, 0, M - 1, 0))           # M-1 zero partitions
    hz = h2.permute(3, 0, 4, 2, 1, 5)                      # [Kp, S, C, P2+M-1, E, Q]
    Kp, S, C, _, E, Q = hz.shape
    pages = []
    for a in range(P2 // M):
        g_a = torch.stack(
            [hz[:, :, :, m + a * M: m + a * M + M] for m in range(M)], dim=4,
        )  # [Kp, S, C, M(j), M(m), E, Q]
        pages.append(g_a.permute(0, 4, 5, 6, 1, 2, 3)
                     .reshape(Kp, M * E * Q, S * C * M))
    return torch.stack(pages)


def project_weights(params: ConvParams, k_padded: int,
                    post: "torch.Tensor | None" = None) -> torch.Tensor:
    """Synthesis weights as the left operand [X, Q*Kp] of one matmul over
    the MAC output's (plane, bin) rows. A `post` matrix [T, X] is folded in
    (einsum(wi, post)), so an irfft-then-matmul chain is one product and the
    time-domain intermediate never exists.

    The fold is built once, in fp32 under every tier: more accurate than
    the JAX package's fold at DFT_PRECISION (airwave_tpu/ops/upols.py:791).
    The product that applies the weights runs at fftmm.DFT_PRECISION."""
    w = params.wi                                           # [K, Q, T]
    if post is not None:
        w = torch.einsum("kqt,tx->kqx", w, post)
    w = F.pad(w, (0, 0, 0, 0, 0, k_padded - w.shape[0]))    # [Kp, Q, X]
    return w.permute(2, 1, 0).reshape(w.shape[2], -1).contiguous()


# --- Single-block step --------------------------------------------------------


def _to_slot(X_planes: torch.Tensor, k_padded: int) -> torch.Tensor:
    """Analysis spectra [B, S, K, 2] -> one delay-line slot [Kp, S, 1, 2, B]."""
    X_km = X_planes.permute(2, 1, 3, 0)  # [K, S, 2, B]
    X_km = F.pad(X_km, (0, 0, 0, 0, 0, 0, 0, k_padded - X_km.shape[0]))
    return X_km.unsqueeze(2)


def _mac_columns(fdl: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """mac_kmajor over h's output columns in runs whose h[k] fits the
    kernel's shared memory (one launch for every steady and dual bank; a
    fade bank of many halves takes several launches, each writing its rows
    of the [O, Kp, B] output). h is [Kp, O, R] or a rotated window; each
    run is a view of it."""
    K, O = h.shape[:2]
    run = max(4, max_columns(fdl.shape[1]) // 4 * 4)
    if O <= run or fdl.device.type == "cpu":
        return mac_kmajor(fdl, h)
    out = torch.empty((O, K, fdl.shape[-1]), dtype=fdl.dtype, device=fdl.device)
    for o in range(0, O, run):
        mac_kmajor(fdl, h[:, o:o + run], out=out[o:o + run])
    return out


def _mac_irfft(fdl: torch.Tensor, h: torch.Tensor,
               synth: torch.Tensor) -> torch.Tensor:
    """Delay-line MAC + second-half inverse DFT:
    fdl [Kp, S, P, C, B], h [Kp, E*Q, S*P*C] or its window [Kp, E*Q, S, P,
    C], synth [T, Q*Kp] -> y [B, E, T].

    The MAC is the mac_kmajor kernel (its plain version on CPU tensors);
    its [E*Q, Kp, B] output is the synthesis matmul's right operand as it
    lies, and y is returned as a [B, E, T] view of the [E, T, B] product."""
    Kp, S, P, C, B = fdl.shape
    Y = _mac_columns(fdl.view(Kp, S * P * C, B), h)     # [E*Q, Kp, B]
    E = h.shape[1] // 2
    with span(CONV_SYNTHESIS):
        y = precision.matmul(synth, Y.view(E, 2 * Kp, B),
                             fftmm.DFT_PRECISION, a_key=synth)  # [E, T, B]
    return y.permute(2, 0, 1)


def conv_step(params: ConvParams, state: ConvState, x: torch.Tensor,
              bank: "torch.Tensor | None" = None,
              synth: "torch.Tensor | None" = None,
              active_mask: "torch.Tensor | None" = None):
    """One overlap-save block: x [B, S, T] float32 -> (state', y [B, E, T]).

    y[b, e] = sum_s conv(x_s, H[s, e]). The slot written is the
    half-window spectrum of the new block alone, IN PLACE in state.fdl:
    the state passed in is consumed and the returned one holds the same
    tensor (the reference returns a new line). `bank` (single_block_bank)
    and `synth` (project_weights) may be passed in so a stepping loop
    builds them once.

    `active_mask` [B] bool (the serving pool's shared-cursor ring): an
    inactive lane's slot is preserved exactly (the current slot, 1/P2 of
    the line, is read back and `where`d into the write) while the shared
    cursor still advances; the pool re-aligns the lane with
    conv_roll_lanes before it next steps. An inactive lane's output row is
    garbage and must not be delivered."""
    Kp, S, P2 = state.fdl.shape[:3]
    w = int(state.write_pos)
    if bank is None:
        bank = single_block_bank(params, Kp)
    if synth is None:
        synth = project_weights(params, Kp)

    with span(CONV_ANALYSIS):
        u = fftmm.rfft_mm(x, params.wf)                  # [B, S, K, 2]
        slot = state.fdl.narrow(2, w, 1)
        new = _to_slot(u, Kp)
        if active_mask is not None:
            new = torch.where(active_mask.to(torch.bool), new, slot)
        slot.copy_(new)
    y = _mac_irfft(state.fdl, _rotated_window(bank, w), synth)
    return ConvState(fdl=state.fdl, write_pos=(w + 1) % P2), y


def migrate_full_window_fdl(fdl_old: np.ndarray, overlap: np.ndarray,
                            write_pos: int,
                            debt: "np.ndarray | None" = None) -> np.ndarray:
    """Convert a FULL-window delay line (the pre-half-window carry: slots
    hold 2T-window spectra X_t, plus the carried previous block
    `overlap`) into the half-window line (slots hold u_t). Host numpy,
    the reference's math: the shift theorem X_t = u_{t-1} + s ⊙ u_t with
    s_k = (-1)^k, u_t = DFT_2T([b_t, 0]) from `overlap` (the last block),
    and every earlier u by the backward recursion
    u_{t-j-1} = X_{t-j} - s ⊙ u_{t-j} in float64. P full-window slots and
    the overlap give the P+1 half-window slots the new carry needs. A
    resumed stream continues within f64 rounding of the uninterrupted
    render, not bit for bit.

    fdl_old: [Kp, S, P, 2, B] (pad bin rows beyond K = T+1 are zero),
    overlap: [B, S, T], write_pos: the old cursor (slot (w-1-j) mod P
    holds X_{t-j}); debt: optional [B] per-lane missed-cursor counts,
    repaid here (conv_roll_lanes applied per lane before the recursion,
    so the returned line is debt-free).

    Returns the new [Kp, S, P+1, 2, B] line under the SAME cursor value
    (valid: w < P < P+1): slot (w-1-j) mod (P+1) holds u_{t-j}."""
    kp, S, P, _, B = fdl_old.shape
    T = overlap.shape[-1]
    K = T + 1
    assert overlap.shape == (B, S, T), (overlap.shape, (B, S, T))
    w = int(write_pos)

    # The line stays f32 (a resumed serving carry can be gigabytes); only
    # the recursion's working set is f64, and each stored slot is that f64
    # u downcast once.
    fdl = np.asarray(fdl_old, np.float32)
    if debt is not None:
        d = np.asarray(debt, np.int64) % P
        lanes = np.nonzero(d)[0]
        if lanes.size:
            fdl = fdl.copy()  # the caller's snapshot is not mutated
            for b in lanes:
                # conv_roll_lanes: new slot p takes old slot (p-d) mod P.
                src = (np.arange(P) - d[b]) % P
                fdl[:, :, :, :, b] = np.take(fdl[:, :, :, :, b], src, axis=2)

    padded = np.zeros((B, S, 2 * T), np.float64)
    padded[..., :T] = np.asarray(overlap, np.float64)
    u = np.fft.rfft(padded, axis=-1)               # [B, S, K] complex128
    u = np.transpose(u, (2, 1, 0))                 # [K, S, B]
    s = ((-1.0) ** np.arange(K))[:, None, None]

    new = np.zeros((kp, S, P + 1, 2, B), np.float32)
    for j in range(P + 1):
        slot = (w - 1 - j) % (P + 1)
        new[:K, :, slot, 0, :] = u.real
        new[:K, :, slot, 1, :] = u.imag
        if j < P:
            old_slot = (w - 1 - j) % P
            X = (fdl[:K, :, old_slot, 0, :].astype(np.float64)
                 + 1j * fdl[:K, :, old_slot, 1, :].astype(np.float64))
            u = X - s * u                          # u_{t-j-1}
    return new


def conv_roll_lanes(state: ConvState, lane_idx: torch.Tensor,
                    shift: torch.Tensor) -> ConvState:
    """Re-align paused lanes to the shared ring cursor, in place.

    A lane that sat out d cursor advances (its slot preserved by
    conv_step's active_mask) holds spectra rotated by d against the
    cursor; rolling its slot axis forward by d mod P2 restores exact
    alignment for any pause length (a full lap is the identity).

    lane_idx [k] int64 lanes (distinct, in range: no sentinel entries),
    shift [k] integer. Only those lanes' columns are read and written
    (index_copy_ on the batch axis), so state.fdl stays the one
    contiguous buffer the kernel reads."""
    P2 = state.fdl.shape[2]
    sh = shift.to(torch.int64) % P2
    lanes = state.fdl.index_select(4, lane_idx)              # [Kp,S,P2,C,k]
    # new slot p takes old slot (p - shift) mod P2
    src = (torch.arange(P2, device=sh.device)[:, None] - sh[None, :]) % P2
    rolled = torch.gather(lanes, 2, src[None, None, :, None, :].expand_as(lanes))
    state.fdl.index_copy_(4, lane_idx, rolled)
    return state


# --- M-block lookahead step (paged delay line) ------------------------------


def conv_step_paged_raw(params: ConvParams, state: PagedConvState,
                        x: torch.Tensor, bank: "torch.Tensor | None" = None,
                        active_mask: "torch.Tensor | None" = None):
    """Analysis + MAC of the M-block lookahead step, stopping before the
    synthesis transform: x [B, S, M, T] -> (state', Ykm [M, E, Q, Kp, B]).

    Ykm is the frequency-domain mix in the kernel's output layout (rows
    (m, e, q), then bin, then batch); paged_project consumes it as it lies.
    `bank` is paged_bank(params, M, Kp), built once by stepping loops.

    `active_mask` [B] bool (the serving pool's multi-block tier): an idle
    lane's column of the outgoing oldest page is `where`d into the new
    page, so its rotation is cyclic and nothing is lost; after d idle
    rounds its pages sit rotated by d, which the pool repairs with
    conv_roll_lanes_paged before the lane next steps. An idle lane's
    output row is garbage and must not be delivered. The step is
    functional: the pages passed in are not written."""
    B, S, M, T = x.shape
    Kp = state.pages[0].shape[0]
    K = params.wf.shape[1]
    if bank is None:
        bank = paged_bank(params, M, Kp)

    # Half-window analysis, newest block first: slot j holds block M-1-j.
    with span(CONV_ANALYSIS):
        xt = x.flip(2).permute(3, 1, 2, 0).reshape(T, S * M * B)  # [t, (s,j,b)]
        u = precision.matmul(params.wf.reshape(T, K * 2).t(), xt,
                             fftmm.DFT_PRECISION,
                             a_key=params.wf)             # [(k,c), (s,j,b)]
        new_page = F.pad(u.view(K, 2, S, M, B).transpose(1, 2),
                         (0, 0, 0, 0, 0, 0, 0, 0, 0, Kp - K))  # [Kp, S, C, M, B]
        if active_mask is not None:
            new_page = torch.where(active_mask.to(torch.bool), new_page,
                                   state.pages[-1])
    pages = (new_page,) + tuple(state.pages[:-1])
    return PagedConvState(pages=pages), _paged_mac(pages, bank, M)


def _paged_mac(pages, bank: torch.Tensor, M: int) -> torch.Tensor:
    """Multiply-accumulate every page against its filter window (bank
    [n_pages, Kp, O, R]) in one mac_kmajor_pages launch, which writes the
    [O, Kp, B] sum once (O = M*E*Q); returned as Ykm [M, E, Q, Kp, B]."""
    Kp, S, C, _, B = pages[0].shape
    Y = mac_kmajor_pages([page.view(Kp, S * C * M, B) for page in pages], bank)
    return Y.view(M, Y.shape[0] // (2 * M), 2, Kp, B)


def paged_project(params: ConvParams, Ykm: torch.Tensor,
                  post: "torch.Tensor | None" = None,
                  synth: "torch.Tensor | None" = None) -> torch.Tensor:
    """Second-half inverse DFT of the paged MAC output:
    Ykm [M, E, Q, Kp, B] -> y [B, M, E, X] (a view of an [M, E, X, B]
    product). With post=None X = T; a `post` matrix [T, X] is folded into
    the weights (project_weights). `synth` passes those weights in."""
    M, E, Q, Kp, B = Ykm.shape
    if synth is None:
        synth = project_weights(params, Kp, post)
    with span(CONV_SYNTHESIS):
        y = precision.matmul(synth, Ykm.reshape(M * E, Q * Kp, B),
                             fftmm.DFT_PRECISION, a_key=synth)  # [M*E, X, B]
    return y.view(M, E, -1, B).permute(3, 0, 1, 2)


def conv_step_paged(params: ConvParams, state: PagedConvState,
                    x: torch.Tensor, bank: "torch.Tensor | None" = None,
                    synth: "torch.Tensor | None" = None,
                    active_mask: "torch.Tensor | None" = None):
    """M-block lookahead step: x [B, S, M, T] -> (state', y [B, M, E, T]),
    conv_step_paged_raw then paged_project."""
    new_state, Ykm = conv_step_paged_raw(params, state, x, bank, active_mask)
    return new_state, paged_project(params, Ykm, synth=synth)


def conv_roll_lanes_paged(state: PagedConvState, lane_idx: torch.Tensor,
                          shift: torch.Tensor) -> PagedConvState:
    """Re-align paused lanes of a paged delay line, in place.

    An idle lane's masked step recycles its oldest page into the new page
    0, so after d idle rounds its page i holds what page (i - d) mod n held
    at pause time; new[i] = cur[(i + d) mod n] restores the order for any
    pause length (a full cycle is the identity).

    lane_idx [k] int64 lanes (distinct, in range: no sentinel entries),
    shift [k] integer idle-round counts. Only those lanes' columns of each
    page are read and written (index_copy_ on the batch axis)."""
    n = len(state.pages)
    sh = shift.to(torch.int64) % n
    lanes = torch.stack([pg.index_select(4, lane_idx) for pg in state.pages])
    src = (torch.arange(n, device=sh.device)[:, None] + sh[None, :]) % n
    rolled = torch.gather(lanes, 0, src[:, None, None, None, None, :]
                          .expand_as(lanes))
    for pg, r in zip(state.pages, rolled):
        pg.index_copy_(4, lane_idx, r)
    return state


def pad_conv_params(params: ConvParams, partitions: int) -> ConvParams:
    """Zero-pad a bank's partition count to `partitions` (tail zeros).

    The padded bank is the same filter (zero tail partitions convolve
    nothing) on a larger delay-line shape, so a shorter-HRIR preset can
    hot-swap onto an existing carry without reallocating it (and, with
    xfade_conv_params, without resetting it). The natural-order bank is
    rebuilt from the stored flip-doubled planes, padded, and flipped and
    doubled again. Padding keeps a lookahead zero tail (zeros extend
    zeros); the caller checks divisibility for the paged step
    (partitions % M). With the bank's own count the params come back
    unchanged."""
    P2 = params.partition_count
    partitions = int(partitions)
    if partitions == P2:
        return params
    if partitions < P2:
        raise ValueError(
            f"pad_conv_params cannot shrink: bank has {P2} partitions, "
            f"asked for {partitions}"
        )
    g_nat = params.Gflip2[:, :, :P2].flip(2)                # [S, E, P2, K, 2]
    g_nat = F.pad(g_nat, (0, 0, 0, 0, 0, partitions - P2))
    g_flip = g_nat.flip(2)
    return ConvParams(Gflip2=torch.cat([g_flip, g_flip], dim=2),
                      wf=params.wf, wi=params.wi)


# --- HRIR hot-swap: the dual bank and the crossfade -------------------------


def _check_same_bank_shape(old: ConvParams, new: ConvParams, what: str,
                           hint: str = "") -> None:
    if old.Gflip2.shape != new.Gflip2.shape:
        raise ValueError(
            f"{what} banks must share [S, E, partitions, K]: "
            f"{tuple(old.Gflip2.shape)} vs {tuple(new.Gflip2.shape)}{hint}"
        )


def xfade_conv_params(old, new: ConvParams) -> ConvParams:
    """Fade-bank params for a crossfaded HRIR hot-swap: the banks stacked
    on the ear axis (E -> 2E; ears [0, E) OLD, [E, 2E) NEW), with `new`'s
    analysis and synthesis weights. `old` may be a sequence of H-1 banks
    (E -> H*E, the NEW bank last): a pool whose lanes last played
    different banks (a second swap while fades are pending) blends each
    lane from its own half (xfade_blend's `src`).

    The delay line holds bank-independent input spectra, so a same-shape
    swap keeps the whole input history, and every step variant runs the
    fade bank unchanged: it reads the delay line once and emits y2
    [..., H*E, T], whose halves xfade_blend mixes per sample. The MAC's
    output columns grow H-fold for the fade round (O = H*E*Q single-block,
    M*H*E*Q paged); the delay-line read does not."""
    olds = [old] if isinstance(old, ConvParams) else list(old)
    for o in olds:
        _check_same_bank_shape(o, new, "crossfade",
                               " (pad_conv_params can grow the smaller one)")
    return ConvParams(Gflip2=torch.cat([o.Gflip2 for o in olds]
                                       + [new.Gflip2], dim=1),
                      wf=new.wf, wi=new.wi)


def lerp_bank(old: ConvParams, new: ConvParams, t: float) -> ConvParams:
    """Pointwise blend of two same-shape banks, (1-t)*old + t*new.

    Convolution is linear in the bank, so the lerped bank renders the
    blend of the two banks' outputs at ratio t: the frozen mid-point of an
    interrupted crossfade, from which a second swap restarts its fade
    (BinauralEngine.set_renderer) without a step in the output filter."""
    _check_same_bank_shape(old, new, "lerp")
    t = float(t)
    return ConvParams(Gflip2=(1.0 - t) * old.Gflip2 + t * new.Gflip2,
                      wf=new.wf, wi=new.wi)


def xfade_ramp(fade: int, total: int) -> np.ndarray:
    """Blend weights of one crossfade window: [total] float32 rising as
    (t+1)/fade over the first `fade` samples (the EQ ramp's convention),
    then holding 1.0."""
    fade = max(1, int(fade))
    r = (np.arange(total, dtype=np.float32) + 1.0) / float(fade)
    return np.minimum(r, 1.0)


def xfade_blend(y2: torch.Tensor, ramp: torch.Tensor,
                lane_mask: "torch.Tensor | None" = None,
                src: "torch.Tensor | None" = None,
                halves: int = 2) -> torch.Tensor:
    """Mix a fade-bank step's halves: y2 [B, H*E, T] (or [B, M, H*E, T])
    -> [B, E, T] (or [B, M, E, T]), y = y_old*(1 - r) + y_new*r, with H =
    `halves` and the NEW half last.

    `ramp` is [T] for the single-block step, or [M*T] spanning the paged
    round. `lane_mask` [B] bool selects the lanes that blend; the others
    take the pure NEW half (lanes that already faded, or attached after
    the swap). `src` [B] int64 picks each lane's OLD half (the bank it
    last played); None takes half 0 for every lane."""
    E = y2.shape[-2] // halves
    y_new = y2[..., (halves - 1) * E:, :]
    if src is None:
        y_old = y2[..., :E, :]
    else:
        parts = y2.unflatten(-2, (halves, E))     # [B, (M,) H, E, T]
        pick = src.to(torch.int64).reshape((y2.shape[0],) + (1,) * (y2.dim() - 1))
        y_old = torch.gather(parts, -3, pick.unsqueeze(-1).expand(
            parts.shape[:-3] + (1,) + parts.shape[-2:])).squeeze(-3)
    r = ramp.to(y2.dtype)
    if y2.dim() == 4:
        r = r.reshape(1, y2.shape[1], 1, y2.shape[-1])
    else:
        r = r.reshape(1, 1, y2.shape[-1])
    y = y_old * (1.0 - r) + y_new * r
    if lane_mask is not None:
        m = lane_mask.to(torch.bool).reshape((y2.shape[0],)
                                             + (1,) * (y2.dim() - 1))
        y = torch.where(m, y, y_new)
    return y
