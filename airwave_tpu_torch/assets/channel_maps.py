"""Virtual speaker positions, input layouts, and HRIR channel maps.

The port's own copy of airwave_tpu/assets/channel_maps.py, the same code: the port
imports no module of the JAX package.

Re-implements Airwave/VirtualSpeaker.swift:11-346:
  - VirtualSpeaker enum (7.1.4 Atmos + custom)
  - InputLayout presets + detect-by-count
  - HRIRChannelMap builders: interleaved_pairs (+legacy), split_blocks,
    hesuvi_7_channel (left-ear synthesis by symmetric swap),
    hesuvi_14_channel (the production map), and the mix.txt parser.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# Speakers are plain strings; custom speakers are "custom:<name>".
FL, FR, FC, LFE = "FL", "FR", "FC", "LFE"
BL, BR, SL, SR = "BL", "BR", "SL", "SR"
TFL, TFR, TBL, TBR = "TFL", "TFR", "TBL", "TBR"
FLC, FRC, BC = "FLC", "FRC", "BC"

_LEFT_SIDE = {FL, BL, SL, TFL, TBL, FLC}
_RIGHT_SIDE = {FR, BR, SR, TFR, TBR, FRC}

_DISPLAY_NAMES = {
    FL: "Front Left", FR: "Front Right", FC: "Front Center", LFE: "LFE",
    BL: "Back Left", BR: "Back Right", SL: "Side Left", SR: "Side Right",
    TFL: "Top Front Left", TFR: "Top Front Right",
    TBL: "Top Back Left", TBR: "Top Back Right",
    FLC: "Front Left Center", FRC: "Front Right Center", BC: "Back Center",
}


def custom(name: str) -> str:
    return f"custom:{name}"


def display_name(speaker: str) -> str:
    if speaker.startswith("custom:"):
        return speaker[len("custom:"):]
    return _DISPLAY_NAMES.get(speaker, speaker)


@dataclasses.dataclass(frozen=True)
class InputLayout:
    channels: Tuple[str, ...]
    name: str


STEREO = InputLayout((FL, FR), "Stereo")
SURROUND_5_1 = InputLayout((FL, FR, FC, LFE, BL, BR), "5.1 Surround")
SURROUND_7_1 = InputLayout((FL, FR, FC, LFE, BL, BR, SL, SR), "7.1 Surround")
ATMOS_7_1_4 = InputLayout(
    (FL, FR, FC, LFE, BL, BR, SL, SR, TFL, TFR, TBL, TBR), "7.1.4 Atmos"
)


def detect_layout(channel_count: int) -> InputLayout:
    """Layout from channel count (ref VirtualSpeaker.swift:88-99)."""
    if channel_count == 2:
        return STEREO
    if channel_count == 6:
        return SURROUND_5_1
    if channel_count == 8:
        return SURROUND_7_1
    if channel_count == 12:
        return ATMOS_7_1_4
    channels = tuple(custom(f"Ch{i}") for i in range(channel_count))
    return InputLayout(channels, f"{channel_count} Channel")


class HRIRChannelMap:
    """speaker -> (left_ear_index, right_ear_index) into the HRIR channels."""

    def __init__(self) -> None:
        self._mapping: Dict[str, Tuple[int, int]] = {}

    def set_mapping(self, speaker: str, left_ear: int, right_ear: int) -> None:
        self._mapping[speaker] = (left_ear, right_ear)

    def indices(self, speaker: str) -> Optional[Tuple[int, int]]:
        return self._mapping.get(speaker)

    def has_mapping(self, speaker: str) -> bool:
        return speaker in self._mapping

    def mapped_speakers(self) -> List[str]:
        return list(self._mapping)


def interleaved_pairs(speakers) -> HRIRChannelMap:
    """Side-dependent ear swap over interleaved pairs (ref VirtualSpeaker.swift:126-159)."""
    m = HRIRChannelMap()
    for index, speaker in enumerate(speakers):
        base = index * 2
        if speaker in _LEFT_SIDE:
            m.set_mapping(speaker, base, base + 1)
        elif speaker in _RIGHT_SIDE:
            m.set_mapping(speaker, base + 1, base)
        else:
            m.set_mapping(speaker, base, base + 1)
    return m


# The legacy map is behaviorally identical in the reference (kept for tests,
# ref VirtualSpeaker.swift:163-196).
interleaved_pairs_legacy = interleaved_pairs


def split_blocks(speakers) -> HRIRChannelMap:
    """Ch0..N-1 = left-ear IRs, ChN..2N-1 = right-ear (ref VirtualSpeaker.swift:200-209)."""
    m = HRIRChannelMap()
    count = len(speakers)
    for index, speaker in enumerate(speakers):
        m.set_mapping(speaker, index, index + count)
    return m


# REFERENCE-EXACT (VirtualSpeaker.swift:224-250): this 7-track layout is
# FL-l, FL-r, FC, BL-l, BL-r, SL-l, SL-r — it is NOT the left half of the
# 14-channel order (which would put SL at 2-3 and BL at 4-5). Do not
# "fix" it to match the 14-channel table; parity with the reference's
# hesuvi7Channel map is the contract.
_HESUVI7 = {
    FL: (0, 1), FR: (1, 0), FC: (2, 2), LFE: (2, 2),
    BL: (3, 4), BR: (4, 3), SL: (5, 6), SR: (6, 5),
}


def hesuvi_7_channel(speakers) -> HRIRChannelMap:
    """Left-ear-only HeSuVi layout, right ear by symmetric swap
    (ref VirtualSpeaker.swift:224-250)."""
    m = HRIRChannelMap()
    for speaker in speakers:
        if speaker in _HESUVI7:
            m.set_mapping(speaker, *_HESUVI7[speaker])
    return m


# Production 14-channel HeSuVi order: L0 L1 SL0 SL1 RL0 RL1 C0 R1 R0 SR1 SR0
# RR1 RR0 C1 (ref VirtualSpeaker.swift:252-297).
_HESUVI14 = {
    FL: (0, 1), FR: (8, 7), FC: (6, 13), LFE: (6, 13),
    BL: (4, 5), BR: (12, 11), SL: (2, 3), SR: (10, 9),
}


def hesuvi_14_channel(speakers) -> HRIRChannelMap:
    m = HRIRChannelMap()
    for speaker in speakers:
        if speaker in _HESUVI14:
            m.set_mapping(speaker, *_HESUVI14[speaker])
    return m


_NAME_TO_SPEAKER = {
    "FL": FL, "L": FL, "FR": FR, "R": FR, "FC": FC, "C": FC,
    "LFE": LFE, "SUB": LFE, "BL": BL, "RL": BL, "BR": BR, "RR": BR,
    "SL": SL, "SR": SR, "TFL": TFL, "TFR": TFR, "TBL": TBL, "TBR": TBR,
}


def parse_hesuvi_format(text: str) -> HRIRChannelMap:
    """Parse a HeSuVi-style mix.txt: lines of "FL = 0, 1"
    (ref VirtualSpeaker.swift:301-346)."""
    m = HRIRChannelMap()
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        parts = line.split("=")
        if len(parts) != 2:
            continue
        name = parts[0].strip()
        tokens = [t.strip() for t in parts[1].strip().split(",")]
        indices = []
        for t in tokens:
            try:
                indices.append(int(t))
            except ValueError:
                pass
        if len(indices) != 2:
            continue
        speaker = _NAME_TO_SPEAKER.get(name.upper(), custom(name))
        m.set_mapping(speaker, indices[0], indices[1])
    return m


def select_channel_map(hrir_channel_count: int, speakers) -> HRIRChannelMap:
    """Channel-map policy from HRIR channel count: 7 -> hesuvi7, else hesuvi14
    (ref HRIRManager.swift:355-360)."""
    if hrir_channel_count == 7:
        return hesuvi_7_channel(speakers)
    return hesuvi_14_channel(speakers)
