"""Host I/O: EqualizerAPO presets and WAV files."""
