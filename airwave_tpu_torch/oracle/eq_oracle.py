"""Float64 per-sample oracle for the parametric EQ cascade.

The port's own copy of airwave_tpu/oracle/eq_oracle.py (numpy and scipy
only): the host EQ of the batch-1 live graph runs on it.

Semantics replicate the reference render-path exactly
(the reference's Airwave/ParametricEqualizerProcessor.swift:58-97):
  - float32 I/O, float64 internal accumulation
  - preamp 10^(dB/20) applied before the first filter
  - DF2T cascade, sequential per sample
  - subnormal flush of the z state at |z| < 1e-30

Two paths:
  - `EqCascadeOracle.process`: scipy.signal.sosfilt (C-speed, float64, no
    subnormal flush — indistinguishable above 1e-30 signal levels)
  - `EqCascadeOracle.process_exact`: pure-Python per-sample loop including the
    subnormal flush, for the tiny golden fixtures that observe it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy import signal

from airwave_tpu_torch.ops.biquad_design import BiquadCoefficients

_FLUSH = 1e-30


class EqCascadeOracle:
    """Stateful stereo cascade with float64 internals, float32 I/O."""

    def __init__(
        self,
        coefficients: Sequence[BiquadCoefficients],
        preamp_linear: float,
        sample_rate: float,
    ) -> None:
        self.sample_rate = float(sample_rate)
        self.preamp_linear = float(preamp_linear)
        self.coefficients = list(coefficients)
        nsec = len(self.coefficients)
        if nsec:
            self._sos = np.array(
                [[c.b0, c.b1, c.b2, 1.0, c.a1, c.a2] for c in self.coefficients],
                np.float64,
            )
        else:
            self._sos = None
        # zi[channel][section] = (z1, z2)
        self._zi = np.zeros((2, max(nsec, 1), 2), np.float64)

    def reset(self) -> None:
        self._zi[:] = 0.0

    def process(self, left: np.ndarray, right: Optional[np.ndarray] = None):
        """Block process via sosfilt. Returns (left_out, right_out) float32."""
        left = np.asarray(left, np.float32)
        right_in = left if right is None else np.asarray(right, np.float32)
        outs = []
        for ch, x in enumerate((left, right_in)):
            u = x.astype(np.float64) * self.preamp_linear
            if self._sos is None:
                y = u
            else:
                y, self._zi[ch] = signal.sosfilt(self._sos, u, zi=self._zi[ch])
            outs.append(y.astype(np.float32))
        return outs[0], outs[1]

    def process_exact(self, left: np.ndarray, right: Optional[np.ndarray] = None):
        """Per-sample loop with the 1e-30 subnormal flush (slow; tiny inputs)."""
        left = np.asarray(left, np.float32)
        right_in = left if right is None else np.asarray(right, np.float32)
        n = len(left)
        out = np.zeros((2, n), np.float32)
        coeffs = self.coefficients
        for frame in range(n):
            vals = [
                float(left[frame]) * self.preamp_linear,
                float(right_in[frame]) * self.preamp_linear,
            ]
            for ch in range(2):
                v = vals[ch]
                for fi, c in enumerate(coeffs):
                    z1, z2 = self._zi[ch, fi]
                    y = c.b0 * v + z1
                    z1n = c.b1 * v - c.a1 * y + z2
                    z2n = c.b2 * v - c.a2 * y
                    self._zi[ch, fi, 0] = 0.0 if abs(z1n) < _FLUSH else z1n
                    self._zi[ch, fi, 1] = 0.0 if abs(z2n) < _FLUSH else z2n
                    v = y
                out[ch, frame] = np.float32(v)
        return out[0], out[1]
