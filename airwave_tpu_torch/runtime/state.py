"""Observable runtime state: status + categorized health-issue registry.

Port of airwave_tpu/runtime/state.py, the same host code: the port keeps its
own copy and imports no module of the JAX package.

Re-implements Airwave/AudioRuntimeState.swift:4-146:
7 statuses, capture-access tri-state, and a health registry holding at most
one issue per category, presented sorted by category order.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional


class Status(enum.Enum):
    UNAVAILABLE = "unavailable"
    INACTIVE = "inactive"
    NEEDS_PERMISSION = "needsPermission"
    NATIVE_PASSTHROUGH = "nativePassthrough"
    STARTING = "starting"
    PROCESSING = "processing"
    RECOVERING = "recovering"


class CaptureAccess(enum.Enum):
    UNKNOWN = "unknown"
    DENIED = "denied"
    GRANTED = "granted"


class HealthCategory(enum.IntEnum):
    """Sorted presentation order (ref AudioRuntimeState.swift:4-35)."""

    PERMISSION = 0
    OUTPUT = 1
    CAPTURE = 2
    PIPELINE = 3
    RECOVERY = 4
    SPATIAL = 5
    EQUALIZER = 6


@dataclasses.dataclass(frozen=True)
class RuntimeHealthIssue:
    category: HealthCategory
    message: str


class AudioRuntimeState:
    """Single-writer observable state; observers fire on every publish."""

    def __init__(self) -> None:
        self.status = Status.INACTIVE
        self.capture_access = CaptureAccess.UNKNOWN
        self._issues: Dict[HealthCategory, RuntimeHealthIssue] = {}
        self._observers: List[Callable[["AudioRuntimeState"], None]] = []

    def observe(self, callback: Callable[["AudioRuntimeState"], None]) -> None:
        self._observers.append(callback)

    def _notify(self) -> None:
        for observer in list(self._observers):
            observer(self)

    def publish(self, status: Status) -> None:
        self.status = status
        self._notify()

    def set_capture_access(self, access: CaptureAccess) -> None:
        self.capture_access = access
        self._notify()

    def set_health_issue(
        self,
        category: HealthCategory,
        issue: Optional[RuntimeHealthIssue],
    ) -> None:
        """One issue per category; None clears (swift :120-124)."""
        if issue is None:
            self._issues.pop(category, None)
        else:
            assert issue.category == category
            self._issues[category] = issue
        self._notify()

    def clear_health_issues(self) -> None:
        self._issues.clear()
        self._notify()

    @property
    def health_issues(self) -> List[RuntimeHealthIssue]:
        return [self._issues[c] for c in sorted(self._issues)]
