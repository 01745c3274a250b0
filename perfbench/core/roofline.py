"""The yardstick of a kernel's roofline share: published peaks and the least
work of the chain's multiply-accumulate, counted from the configuration.

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
FLOAT_BYTES = 4


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
