"""EqualizerAPO preset parser.

The port's own copy of airwave_tpu/io/apo.py, the same code: the port
imports no module of the JAX package.

Re-implements the strict parsing contract of
Airwave/EqualizerAPOParser.swift:23-168:
  - 1 MiB max file size, UTF-8 only, BOM strip
  - anchored `Preamp: X dB` and
    `Filter N: ON|OFF PK|LSC|HSC Fc F Hz Gain G dB Q Q` directives
  - '#' comments and blank lines skipped
  - duplicate Preamp, malformed directives, and non-finite/invalid numbers
    produce line-numbered issues; any issue fails the parse
  - at most 64 filter declarations
  - an effective configuration must contain a non-zero preamp or at least
    one enabled supported filter
"""

from __future__ import annotations

import dataclasses
import enum
import math
import re
from typing import List, Optional

from airwave_tpu_torch.utils.errors import EqualizerParseError, ParseIssue

MAX_DATA_SIZE = 1_048_576
MAX_FILTER_COUNT = 64


class FilterType(enum.Enum):
    PEAKING = "peaking"
    LOW_SHELF = "lowShelf"
    HIGH_SHELF = "highShelf"


@dataclasses.dataclass(frozen=True)
class EqualizerFilter:
    source_line: int
    source_number: Optional[int]
    is_enabled: bool
    type: FilterType
    frequency_hz: float
    gain_db: float
    q: float


@dataclasses.dataclass(frozen=True)
class EqualizerDefinition:
    preamp_db: float = 0.0
    filters: tuple = ()

    @property
    def enabled_filters(self) -> List[EqualizerFilter]:
        return [f for f in self.filters if f.is_enabled]


_PREAMP_RE = re.compile(r"^Preamp\s*:\s*(\S+)\s+dB$", re.IGNORECASE)
_FILTER_RE = re.compile(
    r"^Filter(?:\s+([0-9]+))?\s*:\s+(ON|OFF)\s+(PK|LSC|HSC)"
    r"\s+Fc\s+(\S+)\s+Hz\s+Gain\s+(\S+)\s+dB\s+Q\s+(\S+)$",
    re.IGNORECASE,
)

_TYPE_BY_TOKEN = {
    "PK": FilterType.PEAKING,
    "LSC": FilterType.LOW_SHELF,
    "HSC": FilterType.HIGH_SHELF,
}


def _finite_float(token: str) -> Optional[float]:
    # Python's float() is wider than Swift's Double(_:): it accepts
    # underscore digit separators ("1_000") and surrounding whitespace.
    # Hold the strict-parse parity contract by allowing only plain
    # decimal/scientific characters before conversion — plus hex-float
    # literals ("0x1.f4p9"), which Swift's Double(_:) accepts and Python
    # only parses via float.fromhex.
    if not token:
        return None
    if token.lstrip("+-")[:2] in ("0x", "0X"):
        if not all(c in "0123456789abcdefABCDEF.+-pPxX" for c in token):
            return None
        try:
            value = float.fromhex(token)
        except ValueError:
            return None
    elif not all(c in "0123456789.+-eE" for c in token):
        return None
    else:
        try:
            value = float(token)
        except ValueError:
            return None
    # Swift's Double("inf") parses but isFinite rejects; Python float("inf")
    # parses too — reject the same way.
    if not math.isfinite(value):
        return None
    return value


def parse(data: bytes, filename: str) -> EqualizerDefinition:
    if len(data) > MAX_DATA_SIZE:
        raise EqualizerParseError(
            filename, [ParseIssue(None, "file exceeds the 1 MiB limit")]
        )
    try:
        source = data.decode("utf-8")
    except UnicodeDecodeError:
        raise EqualizerParseError(
            filename, [ParseIssue(None, "file is not valid UTF-8")]
        )
    if source.startswith("﻿"):
        source = source[1:]

    preamp_db = 0.0
    has_preamp = False
    filter_declaration_count = 0
    filters: List[EqualizerFilter] = []
    issues: List[ParseIssue] = []

    for index, raw_line in enumerate(re.split(r"\r\n|\r|\n", source)):
        line_number = index + 1
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue

        m = _PREAMP_RE.match(line)
        if m is not None:
            if has_preamp:
                issues.append(ParseIssue(line_number, "duplicate Preamp directive"))
                continue
            value = _finite_float(m.group(1))
            if value is None:
                issues.append(
                    ParseIssue(line_number, "Preamp must be a finite number")
                )
                continue
            preamp_db = value
            has_preamp = True
            continue

        if line.lower().startswith("filter"):
            filter_declaration_count += 1
            if filter_declaration_count > MAX_FILTER_COUNT:
                issues.append(
                    ParseIssue(
                        line_number,
                        "more than 64 filter declarations are not allowed",
                    )
                )
                continue
            m = _FILTER_RE.match(line)
            if m is None:
                issues.append(ParseIssue(line_number, "malformed Filter directive"))
                continue

            source_number = int(m.group(1)) if m.group(1) else None
            is_enabled = m.group(2).upper() == "ON"
            ftype = _TYPE_BY_TOKEN.get(m.group(3).upper())
            if ftype is None:
                issues.append(ParseIssue(line_number, "unsupported filter type"))
                continue

            frequency_hz = _finite_float(m.group(4))
            gain_db = _finite_float(m.group(5))
            q = _finite_float(m.group(6))

            numeric_issues: List[str] = []
            if frequency_hz is not None:
                if frequency_hz <= 0:
                    numeric_issues.append("frequency must be positive")
            else:
                numeric_issues.append("frequency must be a finite number")
            if gain_db is None:
                numeric_issues.append("gain must be a finite number")
            if q is not None:
                if q <= 0:
                    numeric_issues.append("Q must be positive")
            else:
                numeric_issues.append("Q must be a finite number")
            if numeric_issues:
                issues.extend(ParseIssue(line_number, r) for r in numeric_issues)
                continue

            filters.append(
                EqualizerFilter(
                    source_line=line_number,
                    source_number=source_number,
                    is_enabled=is_enabled,
                    type=ftype,
                    frequency_hz=frequency_hz,
                    gain_db=gain_db,
                    q=q,
                )
            )
            continue

        if line.lower().startswith("preamp"):
            issues.append(ParseIssue(line_number, "malformed Preamp directive"))
        else:
            issues.append(ParseIssue(line_number, "unsupported directive"))

    if not issues and preamp_db == 0 and not any(f.is_enabled for f in filters):
        issues.append(
            ParseIssue(
                None,
                "effective configuration must contain a non-zero preamp "
                "or an enabled supported filter",
            )
        )
    if issues:
        raise EqualizerParseError(filename, issues)
    return EqualizerDefinition(preamp_db=preamp_db, filters=tuple(filters))
