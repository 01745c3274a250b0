"""Offline asset tools (the fractional-delay kernel the bundled presets use)."""
