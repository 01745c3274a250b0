"""Error taxonomy mirroring the reference's typed error enums.

The port's own copy of airwave_tpu/utils/errors.py, the same code: the port
imports no module of the JAX package.

Reference anchors:
  - BiquadCoefficientError:                Airwave/BiquadCoefficientBuilder.swift:11-27
  - ParametricEqualizerPreparationError:   Airwave/ParametricEqualizerProcessor.swift:100-118
  - EqualizerParseError (line-numbered):   Airwave/EqualizerAPOParser.swift:3-21
  - WAVError:                              Airwave/WAVLoader.swift:127-148
  - AudioRuntimeError:                     Airwave/AudioPlatformClient.swift:130-141
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


class AirwaveError(Exception):
    """Base class for all framework errors."""


# --- Biquad design -----------------------------------------------------------


class BiquadCoefficientError(AirwaveError):
    pass


class InvalidSampleRate(BiquadCoefficientError):
    def __str__(self) -> str:
        return "Sample rate must be finite and positive."


class InvalidFrequency(BiquadCoefficientError):
    def __str__(self) -> str:
        return "Frequency must be finite, positive, and below Nyquist."


class InvalidQ(BiquadCoefficientError):
    def __str__(self) -> str:
        return "Q must be finite and positive."


class NonFiniteInput(BiquadCoefficientError):
    def __str__(self) -> str:
        return "Filter parameters must be finite."


class NonFiniteCoefficients(BiquadCoefficientError):
    def __str__(self) -> str:
        return "Filter coefficients must be finite."


# --- Equalizer preparation ---------------------------------------------------


class EqualizerPreparationError(AirwaveError):
    pass


class EqInvalidSampleRate(EqualizerPreparationError):
    def __str__(self) -> str:
        return "Sample rate must be finite and positive."


class EqNonFinitePreamp(EqualizerPreparationError):
    def __str__(self) -> str:
        return "Preamp must produce a finite linear gain."


class EqTooManyFilters(EqualizerPreparationError):
    def __init__(self, count: int):
        self.count = count

    def __str__(self) -> str:
        return f"Equalizer supports at most 64 filters; received {self.count}."


class EqInvalidFrameCount(EqualizerPreparationError):
    def __init__(self, count: int, limit: int):
        self.count = count
        self.limit = limit

    def __str__(self) -> str:
        return (
            f"Frames per callback must be in 1..{self.limit}; "
            f"received {self.count}."
        )


class EqInvalidFilter(EqualizerPreparationError):
    def __init__(self, index: int, error: BiquadCoefficientError):
        self.index = index
        self.error = error

    def __str__(self) -> str:
        return f"Filter {self.index + 1} is invalid: {self.error}"


# --- EqualizerAPO parsing ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParseIssue:
    line_number: Optional[int]
    reason: str


class EqualizerParseError(AirwaveError):
    def __init__(self, filename: str, issues: List[ParseIssue]):
        self.filename = filename
        self.issues = list(issues)
        super().__init__(str(self))

    def __str__(self) -> str:
        details = "; ".join(
            f"line {i.line_number}: {i.reason}" if i.line_number is not None else i.reason
            for i in self.issues
        )
        return f"Could not read {self.filename}: {details}"


# --- WAV I/O -----------------------------------------------------------------


class WAVError(AirwaveError):
    pass


# --- Runtime -----------------------------------------------------------------


class AudioRuntimeError(AirwaveError):
    """Runtime/platform failures (ref AudioPlatformClient.swift:130-141)."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        self.detail = detail
        super().__init__(f"{kind}: {detail}" if detail else kind)
