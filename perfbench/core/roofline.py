"""The yardstick of a kernel's roofline share: published peaks and the least
work of the chain's multiply-accumulate and of its relaxed DFT products,
counted from the configuration.

The delay-line MAC contracts, per frequency bin k,

    Y[o, k, b] = sum_pages sum_r fdl[k, r, b] * h[k, o, r]

Its least time reads every input byte once, writes every output byte once,
and does 2*K*R*O*B FLOPs a page, against the published peaks of one H100 SXM
at its full 700 W: 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the
tensor cores. The shapes follow from the configuration alone (block, taps,
speakers, ears, blocks a step), so the share reads the same work whatever
implements the MAC.
"""

from __future__ import annotations

import math
from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12      # dense, on the tensor cores
FLOAT_BYTES = 4
BF16_BYTES = 2
# bf16 passes of one product at a relaxed tier (airwave_tpu_torch's
# ops/precision): bf16x3 at "high", one pass at "default".
RELAXED_PASSES = {"high": 3, "default": 1}


class Contraction(NamedTuple):
    bins: int      # K: block + 1 bins, padded up to a multiple of 8
    rows: int      # R: speakers x partitions x (re, im), or the page's rows
    columns: int   # O: ears x (re, im), times the blocks of a step
    lanes: int     # B
    pages: int     # the paged tier's pages; 1 for the single block

    def bytes(self) -> int:
        K, R, O, B, P = self
        return FLOAT_BYTES * (P * K * R * B + P * K * O * R + O * K * B)

    def flops(self) -> int:
        K, R, O, B, P = self
        return 2 * P * K * R * O * B

    def least_seconds(self) -> float:
        return max(self.bytes() / HBM_BYTES_PER_S,
                   self.flops() / FP32_FLOPS_PER_S)


def chain_contraction(config: dict, lanes: int) -> Contraction:
    """The MAC of one chain step of `config` at `lanes` lanes.

    The delay line holds half-window spectra: ceil(taps / block) partitions
    give one more half-window coefficient. At M blocks a step the bank
    gains M - 1 zero partitions and is cut into pages of M slots."""
    T = config["block_size"]
    K = T + 1 + (-(T + 1)) % 8
    S, E = config["speakers"], config["ears"]
    M = config["blocks_per_step"]
    coefficients = math.ceil(config["hrir_taps"] / T) + 1
    if M == 1:
        return Contraction(K, S * coefficients * 2, E * 2, lanes, 1)
    slots = coefficients + M - 1
    slots += (-slots) % M
    return Contraction(K, S * 2 * M, M * E * 2, lanes, slots // M)


class RelaxedProduct(NamedTuple):
    """weight [rows, inner] @ activation [inner, columns] at a relaxed tier:
    `passes` bf16 products on the tensor cores, fp32 in and out."""
    rows: int
    inner: int
    columns: int
    passes: int

    def bytes(self) -> int:
        M, K, N, P = self
        return (FLOAT_BYTES * (K * N + M * N)   # the activation, the output
                + BF16_BYTES * M * P * K)       # the K-stacked weight operand

    def flops(self) -> int:
        M, K, N, P = self
        return P * 2 * M * K * N

    def least_seconds(self) -> float:
        return max(self.bytes() / HBM_BYTES_PER_S,
                   self.flops() / BF16_FLOPS_PER_S)


def relaxed_dft_products(config: dict, lanes: int) -> list:
    """The analysis and synthesis DFT products of one chain step of `config`
    at `lanes` lanes, at the configuration's tier; [] at "highest", which
    runs no relaxed product.

    Analysis: the half-window DFT, (re, im) of block + 1 bins from the
    block's samples, for every speaker, block of the step and lane.
    Synthesis: the block's samples from the MAC output's (re, im) bins,
    padded as chain_contraction pads them, for every ear, block and lane.
    Only the DFTs count: the EQ columns that the paged tier folds into the
    synthesis are the EQ's work."""
    passes = RELAXED_PASSES.get(config["tier"])
    if passes is None:
        return []
    T = config["block_size"]
    K = T + 1 + (-(T + 1)) % 8
    M = config["blocks_per_step"]
    return [
        RelaxedProduct(2 * (T + 1), T, config["speakers"] * M * lanes, passes),
        RelaxedProduct(T, 2 * K, config["ears"] * M * lanes, passes),
    ]


def share_pct(ops, least_seconds_per_step: float):
    """A kernel's share of its roofline in %: the least time a step times
    the traced steps that launched `ops` (trace.DeviceOp), over their device
    time. An op whose step is unknown counts as a step of its own, as one
    launch a step. None without ops."""
    if not ops:
        return None
    steps = len({op.step for op in ops if op.step is not None})
    steps += sum(1 for op in ops if op.step is None)
    busy_s = sum(op.dur_us for op in ops) / 1e6
    return 100.0 * least_seconds_per_step * steps / busy_s
