"""Biquad coefficient design (host-side, float64) and block state-space lowering.

A numpy port of airwave_tpu/ops/biquad_design.py (the port imports no
module of the JAX package). The arithmetic is the
reference's operation for operation, so every matrix it builds is bit-for-bit
the reference's.

For a block of T samples the <=64-filter cascade becomes one linear
state-space system lowered to block form:

    y[0:T] = (h * x)[0:T] + O @ s0
    s_T    = A^T @ s0 + G @ x

with h the first T samples of the cascade impulse response, O the
observability matrix and G[:, t] = A^(T-1-t) B, all in float64 here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

# The EQ definition types are re-exported, so callers of the port may take
# them from here.
from airwave_tpu_torch.io.apo import EqualizerDefinition, EqualizerFilter, FilterType
from airwave_tpu_torch.utils import errors


@dataclasses.dataclass(frozen=True)
class BiquadCoefficients:
    """Normalized (a0 == 1) biquad coefficients, float64."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float

    def as_array(self) -> np.ndarray:
        return np.array([self.b0, self.b1, self.b2, self.a1, self.a2], np.float64)


def make_biquad(
    type: FilterType,
    gain_db: float,
    frequency_hz: float,
    q: float,
    sample_rate: float,
) -> BiquadCoefficients:
    """RBJ Audio-EQ-Cookbook peaking / low-shelf / high-shelf coefficients."""
    if not (math.isfinite(sample_rate) and sample_rate > 0):
        raise errors.InvalidSampleRate()
    if not (math.isfinite(gain_db) and math.isfinite(frequency_hz) and math.isfinite(q)):
        raise errors.NonFiniteInput()
    if not (frequency_hz > 0 and frequency_hz < sample_rate / 2):
        raise errors.InvalidFrequency()
    if not q > 0:
        raise errors.InvalidQ()

    amplitude = 10.0 ** (gain_db / 40.0)
    omega = 2.0 * math.pi * frequency_hz / sample_rate
    sine = math.sin(omega)
    cosine = math.cos(omega)
    alpha = sine / (2.0 * q)
    beta = 2.0 * math.sqrt(amplitude) * alpha

    if type == FilterType.PEAKING:
        raw = (
            1 + alpha * amplitude,
            -2 * cosine,
            1 - alpha * amplitude,
            1 + alpha / amplitude,
            -2 * cosine,
            1 - alpha / amplitude,
        )
    elif type == FilterType.LOW_SHELF:
        raw = (
            amplitude * ((amplitude + 1) - (amplitude - 1) * cosine + beta),
            2 * amplitude * ((amplitude - 1) - (amplitude + 1) * cosine),
            amplitude * ((amplitude + 1) - (amplitude - 1) * cosine - beta),
            (amplitude + 1) + (amplitude - 1) * cosine + beta,
            -2 * ((amplitude - 1) + (amplitude + 1) * cosine),
            (amplitude + 1) + (amplitude - 1) * cosine - beta,
        )
    elif type == FilterType.HIGH_SHELF:
        raw = (
            amplitude * ((amplitude + 1) + (amplitude - 1) * cosine + beta),
            -2 * amplitude * ((amplitude - 1) + (amplitude + 1) * cosine),
            amplitude * ((amplitude + 1) + (amplitude - 1) * cosine - beta),
            (amplitude + 1) - (amplitude - 1) * cosine + beta,
            2 * ((amplitude - 1) - (amplitude + 1) * cosine),
            (amplitude + 1) - (amplitude - 1) * cosine - beta,
        )
    else:  # pragma: no cover
        raise errors.NonFiniteInput()

    b0r, b1r, b2r, a0r, a1r, a2r = raw
    if not (math.isfinite(a0r) and a0r != 0):
        raise errors.NonFiniteCoefficients()
    coeffs = BiquadCoefficients(
        b0=b0r / a0r, b1=b1r / a0r, b2=b2r / a0r, a1=a1r / a0r, a2=a2r / a0r
    )
    for value in (coeffs.b0, coeffs.b1, coeffs.b2, coeffs.a1, coeffs.a2):
        if not math.isfinite(value):
            raise errors.NonFiniteCoefficients()
    return coeffs


def design_cascade(
    definition: "EqualizerDefinition | None", sample_rate: float
) -> tuple:
    """Validate a definition and return (preamp_linear, [BiquadCoefficients]).

    None -> unity state, disabled filters excluded, >64 enabled filters
    rejected, per-filter errors wrapped with the filter index."""
    if not (math.isfinite(sample_rate) and sample_rate > 0):
        raise errors.EqInvalidSampleRate()

    preamp_db = definition.preamp_db if definition is not None else 0.0
    if not math.isfinite(preamp_db):
        raise errors.EqNonFinitePreamp()
    preamp_linear = 10.0 ** (preamp_db / 20.0)
    if not math.isfinite(preamp_linear):
        raise errors.EqNonFinitePreamp()

    enabled = definition.enabled_filters if definition is not None else []
    if len(enabled) > 64:
        raise errors.EqTooManyFilters(len(enabled))

    coefficients: List[BiquadCoefficients] = []
    for index, filt in enumerate(enabled):
        try:
            coefficients.append(
                make_biquad(
                    filt.type, filt.gain_db, filt.frequency_hz, filt.q, sample_rate
                )
            )
        except errors.BiquadCoefficientError as err:
            raise errors.EqInvalidFilter(index, err)
    return preamp_linear, coefficients


# --- State-space composition --------------------------------------------------


def biquad_state_space(c: BiquadCoefficients) -> tuple:
    """DF2T biquad as (A[2,2], B[2], C[2], D) with state s = (z1, z2):
        y  = b0*x + z1
        z1' = b1*x - a1*y + z2
        z2' = b2*x - a2*y
    """
    A = np.array([[-c.a1, 1.0], [-c.a2, 0.0]], np.float64)
    B = np.array([c.b1 - c.a1 * c.b0, c.b2 - c.a2 * c.b0], np.float64)
    C = np.array([1.0, 0.0], np.float64)
    D = float(c.b0)
    return A, B, C, D


def cascade_state_space(
    coefficients: Sequence[BiquadCoefficients], preamp_linear: float
) -> tuple:
    """Series composition of the cascade into one (A, B, C, D), float64.

    The preamp (applied before the first filter) is folded into B and D.
    State dimension n = 2 * len(coefficients); n == 0 yields a pure gain."""
    A = np.zeros((0, 0), np.float64)
    B = np.zeros((0,), np.float64)
    C = np.zeros((0,), np.float64)
    D = 1.0
    for coeff in coefficients:
        Ai, Bi, Ci, Di = biquad_state_space(coeff)
        n = A.shape[0]
        A2 = np.zeros((n + 2, n + 2), np.float64)
        A2[:n, :n] = A
        A2[n:, :n] = np.outer(Bi, C)
        A2[n:, n:] = Ai
        B2 = np.concatenate([B, Bi * D])
        C2 = np.concatenate([Di * C, Ci])
        D2 = Di * D
        A, B, C, D = A2, B2, C2, D2
    return A, B * preamp_linear, C, D * preamp_linear


@dataclasses.dataclass(frozen=True)
class BlockSSM:
    """Block state-space matrices for one cascade at block size T (float64).

    h:   [T]      first T samples of the cascade impulse response
    O:   [T, n]   y contribution of the initial state   (y += O @ s0)
    A_T: [n, n]   state propagation over the block      (s_T = A_T @ s0 + G @ x)
    G:   [n, T]   input-to-final-state map
    n is padded to `state_dim` with zeros so every preset has one shape.
    """

    h: np.ndarray
    O: np.ndarray
    A_T: np.ndarray
    G: np.ndarray


def block_ssm(
    coefficients: Sequence[BiquadCoefficients],
    preamp_linear: float,
    block_size: int,
    state_dim: int = 128,
) -> BlockSSM:
    A, B, C, D = cascade_state_space(coefficients, preamp_linear)
    n = A.shape[0]
    if n > state_dim:
        raise errors.EqTooManyFilters(n // 2)
    T = block_size

    h = np.zeros(T, np.float64)
    O = np.zeros((T, state_dim), np.float64)
    G = np.zeros((state_dim, T), np.float64)
    A_T = np.zeros((state_dim, state_dim), np.float64)

    h[0] = D
    if n > 0:
        # Forward powers: v_t = A^t B  and row_t = C A^t, iterated in f64.
        v = B.copy()
        row = C.copy()
        O[0, :n] = row
        G[:n, T - 1] = v
        for t in range(1, T):
            h[t] = row @ B      # h[t] = C A^(t-1) B
            row = row @ A       # C A^t
            O[t, :n] = row
            v = A @ v           # A^t B
            G[:n, T - 1 - t] = v
        # A^T via repeated squaring in f64.
        An = np.eye(n, dtype=np.float64)
        base = A.copy()
        e = T
        while e > 0:
            if e & 1:
                An = An @ base
            base = base @ base
            e >>= 1
        A_T[:n, :n] = An

    return BlockSSM(h=h, O=O, A_T=A_T, G=G)
