"""Float64 numpy oracle for Uniform Partitioned Overlap-Save convolution.

The port's own copy of airwave_tpu/oracle/upols_oracle.py (numpy only):
the accuracy gate (tools/validate_accuracy) holds the chains to it on a
machine without jax.

Algorithmic structure mirrors the reference's
Airwave/ConvolutionEngine.swift:68-407 (FFT size = 2*block, HRIR padded to
ceil(len/block) partitions, frequency-domain delay line, zero added
latency), but uses numpy rfft/irfft directly: vDSP's packed-real format
with its 2x forward scaling and 0.25/N output scale
(ConvolutionEngine.swift:304-311, 356-358) algebraically cancels to plain
rfft -> multiply-accumulate -> irfft; we derive the equivalence rather than
emulate the packing.
"""

from __future__ import annotations

import numpy as np


class UPOLSOracle:
    """Single-stream partitioned overlap-save convolver, float64 internals."""

    def __init__(self, hrir: np.ndarray, block_size: int = 512) -> None:
        hrir = np.asarray(hrir, np.float64)
        if hrir.ndim != 1 or hrir.size == 0:
            raise ValueError("hrir must be a non-empty 1-D array")
        self.block_size = int(block_size)
        self.fft_size = self.block_size * 2
        self.partition_count = int(np.ceil(hrir.size / self.block_size))
        padded = np.zeros(self.partition_count * self.block_size, np.float64)
        padded[: hrir.size] = hrir
        parts = padded.reshape(self.partition_count, self.block_size)
        parts = np.concatenate(
            [parts, np.zeros_like(parts)], axis=1
        )  # zero-pad each partition to fft_size
        self.H = np.fft.rfft(parts, axis=1)  # [P, K]
        self.reset()

    def reset(self) -> None:
        self.overlap = np.zeros(self.block_size, np.float64)
        self.fdl = np.zeros_like(self.H)  # [P, K], slot 0 = newest
        self._primed = 0

    def process(self, block: np.ndarray) -> np.ndarray:
        block = np.asarray(block, np.float64)
        assert block.shape == (self.block_size,)
        frame = np.concatenate([self.overlap, block])
        X = np.fft.rfft(frame)
        # Shift the delay line: slot p holds the spectrum of block t-p.
        self.fdl = np.concatenate([X[None, :], self.fdl[:-1]], axis=0)
        Y = np.sum(self.fdl * self.H, axis=0)
        y = np.fft.irfft(Y, n=self.fft_size)
        self.overlap = block.copy()
        return y[self.block_size:]

    def process_f32(self, block: np.ndarray) -> np.ndarray:
        """float32-I/O convenience matching the reference's public dtype."""
        return self.process(np.asarray(block, np.float32)).astype(np.float32)
