"""Central frozen configuration for the Airwave-TPU framework.

The port's own copy of airwave_tpu/config.py, the same code: the port
imports no module of the JAX package.

The reference scatters its constants across typed statics (see SURVEY.md §5
"Config / flag system"); we centralize them in one frozen dataclass.

Reference anchors:
  - block size 512:            Airwave/HRIRManager.swift:149
  - max callback frames 4096:  Airwave/CoreAudioPlatformClient.swift:124
  - crossfade 0.020 s:         Airwave/ParametricEqualizerProcessor.swift:122
  - max filters 64:            Airwave/ParametricEqualizerProcessor.swift:17
  - subnormal flush 1e-30:     Airwave/ParametricEqualizerProcessor.swift:94-97
  - retry ladder [1,2,4,8,15]: Airwave/AudioRuntimeController.swift:79
  - 30 s stability window:     Airwave/AudioRuntimeController.swift:601-607
  - capture signal policy:     Airwave/AudioPlatformClient.swift:153-179
  - rate tolerance 0.5 Hz:     Airwave/AudioPlatformClient.swift:72-81
  - resample identity 0.01 Hz: Airwave/Resampler.swift:33
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AirwaveConfig:
    # DSP core
    block_size: int = 512
    max_frames_per_callback: int = 4096
    crossfade_duration_seconds: float = 0.020
    max_filter_count: int = 64
    subnormal_flush_threshold: float = 1e-30
    # EQ block state-space dimension: 64 biquads x order 2, padded for shape
    # stability so preset swaps never re-jit.
    eq_state_dim: int = 128

    # Runtime / recovery
    retry_ladder_seconds: tuple = (1.0, 2.0, 4.0, 8.0, 15.0)
    stability_window_seconds: float = 30.0
    device_loss_grace_seconds: float = 1.0
    capture_verification_timeout_seconds: float = 2.5
    capture_probe_delay_seconds: float = 0.1

    # Capture signal policy
    capture_min_sustained_frames: int = 2048
    capture_min_amplitude: float = 1e-4

    # Format policy
    sample_rate_tolerance_hz: float = 0.5
    resample_identity_epsilon_hz: float = 0.01

    # Asset management
    preset_watch_debounce_seconds: float = 0.2
    max_eq_file_bytes: int = 1_048_576

    @property
    def fft_size(self) -> int:
        return self.block_size * 2

    @property
    def num_bins(self) -> int:
        """rfft bin count for the overlap-save FFT."""
        return self.fft_size // 2 + 1

    def transition_length(self, sample_rate: float) -> int:
        """Crossfade length in frames (ref ParametricEqualizerProcessor.swift:160)."""
        return max(1, int(round(sample_rate * self.crossfade_duration_seconds)))


DEFAULT_CONFIG = AirwaveConfig()
