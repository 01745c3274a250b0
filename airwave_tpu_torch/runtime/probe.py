"""Capture-verification probe stimulus.

Port of airwave_tpu/runtime/probe.py, the same host code: the port keeps its
own copy and imports no module of the JAX package.

The reference plays a bundled probe WAV to give the capture-verification
pipeline a deterministic signal (Airwave/AudioCaptureProbe.swift:11-29,
AudioRuntimeController plays it 0.1 s after the verification pipeline starts).
Here the stimulus is generated (log-sweep chirp, clearly above the 1e-4
verification threshold) and routed to any sink with a `play_buffer(audio,
sample_rate)` capability — e.g. SyntheticTransport mixes it into its capture
signal while playing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def probe_stimulus(sample_rate: float = 48_000.0, seconds: float = 0.5,
                   amplitude: float = 0.25) -> np.ndarray:
    """Deterministic log-sweep chirp [2, n] float32 (200 Hz -> 4 kHz)."""
    n = int(seconds * sample_rate)
    if n <= 0 or seconds <= 0:
        raise ValueError(
            f"probe stimulus needs a positive duration, got {seconds} s"
        )
    t = np.arange(n) / sample_rate
    f0, f1 = 200.0, 4_000.0
    k = (f1 / f0) ** (1.0 / seconds)
    phase = 2 * np.pi * f0 * (k ** t - 1.0) / np.log(k)
    sweep = (amplitude * np.sin(phase)).astype(np.float32)
    fade = min(n // 10, 480)
    if fade > 0:  # envelope[-0:] would span the whole array
        envelope = np.ones(n, np.float32)
        envelope[:fade] = np.linspace(0, 1, fade, dtype=np.float32)
        envelope[-fade:] = np.linspace(1, 0, fade, dtype=np.float32)
        sweep *= envelope
    return np.stack([sweep, sweep])


class CaptureProbe:
    """Probe player seam (the controller calls play()/stop())."""

    def __init__(self, sink=None, sample_rate: float = 48_000.0) -> None:
        self.sink = sink
        self.sample_rate = sample_rate
        self.playing = False
        self.play_count = 0
        self._stimulus: Optional[np.ndarray] = None

    @property
    def stimulus(self) -> np.ndarray:
        if self._stimulus is None:
            self._stimulus = probe_stimulus(self.sample_rate)
        return self._stimulus

    def play(self) -> None:
        self.playing = True
        self.play_count += 1
        if self.sink is not None and hasattr(self.sink, "play_buffer"):
            self.sink.play_buffer(self.stimulus, self.sample_rate)

    def stop(self) -> None:
        self.playing = False
        if self.sink is not None and hasattr(self.sink, "stop_buffer"):
            self.sink.stop_buffer()
