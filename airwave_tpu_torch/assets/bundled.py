"""Bundled preset catalog: built-in EQ curves + synthesized HRIR sets.

Port of airwave_tpu/assets/bundled.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.

Plays the role of Airwave/BundledPresetCatalog.swift:12-101
(5 EQ presets + 3 HRTF WAVs seeded once into the managed directories, with an
acknowledged-filenames marker so user deletions stick). Our bundled content
is generated, not shipped: EQ presets are authored here as EqualizerAPO text,
and the three HRIR sets (Neutral / Room / Stage) are deterministic synthetic
14-channel HeSuVi banks produced by tools/spatial.py-style synthesis
(ITD via windowed-sinc fractional delay, ILD + contralateral head shadow,
and per-set diffuse decay tails).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from airwave_tpu_torch.io import wav

SEED_MARKER = ".bundled-acknowledged.json"

# Our own curves (values authored for this framework).
BUNDLED_EQ: Dict[str, str] = {
    "Bass Booster.txt": (
        "Preamp: -4.5 dB\n"
        "Filter 1: ON LSC Fc 100.0 Hz Gain 4.5 dB Q 0.71\n"
        "Filter 2: ON PK Fc 55.0 Hz Gain 1.5 dB Q 1.10\n"
    ),
    "Bass Reducer.txt": (
        "Preamp: 0.0 dB\n"
        "Filter 1: ON LSC Fc 100.0 Hz Gain -4.5 dB Q 0.71\n"
    ),
    "Treble Booster.txt": (
        "Preamp: -4.0 dB\n"
        "Filter 1: ON HSC Fc 7500.0 Hz Gain 4.0 dB Q 0.71\n"
    ),
    "Treble Reducer.txt": (
        "Preamp: 0.0 dB\n"
        "Filter 1: ON HSC Fc 7500.0 Hz Gain -4.0 dB Q 0.71\n"
    ),
    "Vocal Booster.txt": (
        "Preamp: -3.0 dB\n"
        "Filter 1: ON PK Fc 1100.0 Hz Gain 2.5 dB Q 1.00\n"
        "Filter 2: ON PK Fc 2800.0 Hz Gain 2.0 dB Q 1.20\n"
        "Filter 3: ON LSC Fc 120.0 Hz Gain -1.5 dB Q 0.71\n"
    ),
}

# HeSuVi 14-channel index layout (ref VirtualSpeaker.swift:252-297):
# (speaker, azimuth degrees, left-ear channel, right-ear channel)
_DIRECTIONS = [
    ("FL", -30.0, 0, 1),
    ("SL", -90.0, 2, 3),
    ("BL", -135.0, 4, 5),
    ("FC", 0.0, 6, 13),
    ("FR", 30.0, 8, 7),
    ("SR", 90.0, 10, 9),
    ("BR", 135.0, 12, 11),
]

SAMPLE_RATE = 48_000.0


def _fractional_delay_kernel(delay_samples: float, taps: int = 65) -> np.ndarray:
    """The offline converter's Blackman-windowed sinc, shared so the
    bundled synthesis can never drift from the pinned delay contract
    (ref tools/ss2-to-hesuvi/convert.py:386-428)."""
    from airwave_tpu_torch.tools.convert import fractional_delay_kernel

    return fractional_delay_kernel(delay_samples, taps)


def synthesize_hrir(style: str = "neutral", length: int = 4096,
                    sample_rate: float = SAMPLE_RATE,
                    seed: int = 1234) -> np.ndarray:
    """Deterministic 14-channel synthetic HRIR bank [14, length] float32.

    Spherical-head approximations: Woodworth ITD, broadband ILD with a
    first-order contralateral head-shadow lowpass; Room/Stage add diffuse
    exponentially-decaying noise tails with style-specific decay/level.
    """
    rng = np.random.default_rng(seed)
    out = np.zeros((14, length), np.float32)
    head_radius = 0.0875  # m
    speed_of_sound = 343.0

    tail_cfg = {
        "neutral": (0.0, 0.0),
        "room": (0.05, 0.018),     # (level, decay seconds)
        "stage": (0.09, 0.045),
    }[style]

    for _, azimuth_deg, left_ch, right_ch, in _DIRECTIONS:
        az = np.deg2rad(azimuth_deg)
        # Woodworth ITD split symmetrically across the two ears. The
        # formula's domain is |az| <= 90 deg; a spherical head's interaural
        # geometry depends only on the angle to the interaural axis, so
        # rear sources mirror (az' = 180 - |az|): ITD shrinks again toward
        # the back instead of growing past the physical maximum at 90.
        az_itd = np.sign(az) * (np.pi - abs(az)) if abs(az) > np.pi / 2 else az
        itd = head_radius / speed_of_sound * (az_itd + np.sin(az_itd))
        half = itd * sample_rate / 2.0
        base_delay = 24.0

        for channel, ear_sign in ((left_ch, +1.0), (right_ch, -1.0)):
            delay = base_delay + ear_sign * half
            # ILD: contralateral ear attenuated up to ~6 dB broadband.
            # (left ear is contralateral for az > 0, right for az < 0)
            shadow = np.clip(-ear_sign * np.sin(az), -1.0, 0.0)
            gain = 10.0 ** (6.0 * shadow / 20.0)
            intd = int(np.floor(delay))
            frac = delay - intd
            kernel = _fractional_delay_kernel(frac) * gain
            start = intd
            stop = min(length, start + len(kernel))
            direct = np.zeros(length)
            direct[start:stop] = kernel[: stop - start]
            if shadow < 0.0:
                # First-order lowpass as the head-shadow spectral tilt.
                alpha = 0.35 * (-shadow)
                filtered = np.empty_like(direct)
                acc = 0.0
                b = 1.0 - alpha
                for i, v in enumerate(direct):
                    acc = b * v + alpha * acc
                    filtered[i] = acc
                direct = filtered
            out[channel] += direct.astype(np.float32)

        tail_level, tail_decay = tail_cfg
        if tail_level > 0.0:
            t = np.arange(length) / sample_rate
            envelope = np.exp(-t / tail_decay)
            onset = int(base_delay) + 40
            for channel in (left_ch, right_ch):
                noise = rng.standard_normal(length) * envelope
                noise[:onset] = 0.0
                out[channel] += (tail_level * noise).astype(np.float32)

    # Normalize so the strongest direct path peaks near 0.9.
    peak = float(np.max(np.abs(out)))
    if peak > 0:
        out *= 0.9 / peak
    return out


BUNDLED_HRIR_STYLES = {
    "Neutral.wav": "neutral",
    "Room.wav": "room",
    "Stage.wav": "stage",
}


def bundled_eq_filenames() -> List[str]:
    return list(BUNDLED_EQ)


def bundled_hrir_filenames() -> List[str]:
    return list(BUNDLED_HRIR_STYLES)


def seed_bundled_presets(eq_manager, hrir_manager, staging_dir: str) -> None:
    """Install bundled presets once; an acknowledged-filenames marker in each
    managed dir makes user deletions stick (ref BundledPresetCatalog.swift:77-93)."""
    os.makedirs(staging_dir, exist_ok=True)

    def acknowledged(directory: str) -> set:
        try:
            with open(os.path.join(directory, SEED_MARKER)) as f:
                return set(json.load(f))
        except (OSError, json.JSONDecodeError):
            return set()

    def acknowledge(directory: str, names: set) -> None:
        with open(os.path.join(directory, SEED_MARKER), "w") as f:
            json.dump(sorted(names), f)

    eq_seen = acknowledged(eq_manager.directory)
    for filename, text in BUNDLED_EQ.items():
        if filename in eq_seen:
            continue
        path = os.path.join(staging_dir, filename)
        with open(path, "w") as f:
            f.write(text)
        eq_manager.import_preset(path, is_bundled=True)
        eq_seen.add(filename)
    acknowledge(eq_manager.directory, eq_seen)

    hrir_seen = acknowledged(hrir_manager.directory)
    for filename, style in BUNDLED_HRIR_STYLES.items():
        if filename in hrir_seen:
            continue
        path = os.path.join(staging_dir, filename)
        wav.save(path, synthesize_hrir(style), SAMPLE_RATE)
        hrir_manager.import_preset(path, is_bundled=True)
        hrir_seen.add(filename)
    acknowledge(hrir_manager.directory, hrir_seen)
