"""Runtime -> user presentation mapping + update state model + launch routing.

Port of airwave_tpu/shell/presentation.py, the same host code: the port
keeps its own copy and imports no module of the JAX package.

Headless re-implementations of the L7 contracts (SURVEY.md §2.2 "App shell"):
  - status/health presentation strings driving a menu/TUI
    (ref ProductSetup.swift:423-551)
  - UpdateStateModel with the benign no-update error case
    (ref UpdateManager.swift:5-49)
  - launch routing policy: login-item silent launch runs headless; a user
    open routes to setup until onboarding completes, then to settings
    (ref AppDelegate.swift:45-142, 508-707)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from airwave_tpu_torch.runtime.state import (
    AudioRuntimeState,
    CaptureAccess,
    Status,
)

_STATUS_PRESENTATION = {
    Status.UNAVAILABLE: ("No output device",
                         "Connect an output device to begin."),
    Status.INACTIVE: ("Inactive", "Rendering is stopped."),
    Status.NEEDS_PERMISSION: ("Permission needed",
                              "Grant system audio capture access."),
    Status.NATIVE_PASSTHROUGH: ("Native passthrough",
                                "Audio is playing without processing."),
    Status.STARTING: ("Starting", "Preparing the render pipeline."),
    Status.PROCESSING: ("Processing", "Spatial rendering is active."),
    Status.RECOVERING: ("Recovering", "Retrying after a pipeline issue."),
}


@dataclasses.dataclass(frozen=True)
class StatusPresentation:
    title: str
    subtitle: str
    health_lines: tuple
    severity: str  # "ok" | "warning" | "error"


def present_status(state: AudioRuntimeState) -> StatusPresentation:
    title, subtitle = _STATUS_PRESENTATION[state.status]
    health = tuple(issue.message for issue in state.health_issues)
    if state.status in (Status.NEEDS_PERMISSION, Status.UNAVAILABLE):
        severity = "error"
    elif health or state.status == Status.RECOVERING:
        severity = "warning"
    else:
        severity = "ok"
    return StatusPresentation(title, subtitle, health, severity)


def capture_guidance(state: AudioRuntimeState) -> Optional[str]:
    """Onboarding capture-card copy (ref ProductSetup.swift:204-360)."""
    if state.capture_access == CaptureAccess.DENIED:
        return ("System audio recording is disabled for this app. "
                "Enable it in your system privacy settings, then retry.")
    if state.capture_access == CaptureAccess.UNKNOWN:
        return "Airwave needs permission to capture system audio."
    if state.status == Status.RECOVERING:
        return "Capture could not be verified yet; retrying automatically."
    return None


# --- update state model ---------------------------------------------------------


class UpdatePhase(enum.Enum):
    IDLE = "idle"
    CHECKING = "checking"
    CURRENT = "current"
    AVAILABLE = "available"
    ERROR = "error"


NO_UPDATE_ERROR_CODE = 1001  # benign "no update found" completion


@dataclasses.dataclass
class UpdateStateModel:
    phase: UpdatePhase = UpdatePhase.IDLE
    version: Optional[str] = None
    message: Optional[str] = None

    def began_checking(self) -> None:
        self.phase, self.version, self.message = UpdatePhase.CHECKING, None, None

    def found(self, version: str) -> None:
        # Clear cross-phase leftovers: a stale error message must not
        # survive into the available/current presentations (and vice
        # versa a stale version into the error state, see failed()).
        self.phase, self.version, self.message = (
            UpdatePhase.AVAILABLE, version, None,
        )

    def found_no_update(self) -> None:
        self.phase, self.version, self.message = (
            UpdatePhase.CURRENT, None, None,
        )

    def finished(self, error_code: Optional[int] = None,
                 message: Optional[str] = None) -> None:
        if error_code is None:
            return
        if error_code == NO_UPDATE_ERROR_CODE:
            # A normal "no update" completion arrives through the error
            # channel too (ref UpdateManager.swift:31-42).
            self.found_no_update()
        else:
            self.failed(message or f"update check failed ({error_code})")

    def failed(self, message: str) -> None:
        self.phase, self.version, self.message = (
            UpdatePhase.ERROR, None, message,
        )


# --- launch routing ----------------------------------------------------------------


class LaunchReason(enum.Enum):
    LOGIN_ITEM = "loginItem"   # silent background launch
    USER_OPEN = "userOpen"     # explicit user action


class LaunchRoute(enum.Enum):
    HEADLESS = "headless"      # run the runtime, show nothing
    SETUP = "setup"            # onboarding flow
    SETTINGS = "settings"      # main surface


def route_launch(reason: LaunchReason, onboarding_complete: bool,
                 onboarding_deferred: bool) -> LaunchRoute:
    """Coarse reason -> route view of the ONE routing policy (see
    window_action below, which owns the decision table)."""
    intent = (
        LaunchIntent.LOGIN_ITEM_LAUNCH
        if reason == LaunchReason.LOGIN_ITEM
        else LaunchIntent.USER_COLD_OPEN
    )
    action = window_action(intent, onboarding_complete, onboarding_deferred)
    return {
        WindowAction.NONE: LaunchRoute.HEADLESS,
        WindowAction.SETUP: LaunchRoute.SETUP,
        WindowAction.SETTINGS: LaunchRoute.SETTINGS,
    }[action]


# --- launch-event classification, queueing, and dedup -------------------------------
#
# Headless equivalent of the reference's Apple-event launch plumbing
# (AppDelegate.swift:45-142, 508-707; contracts pinned by
# ProductSurfaceTests.swift:131-345): a transport-agnostic launch event is
# classified into an intent (login-item marker and trusted login-window
# sender both force the silent path), routed to a surface, deduplicated per
# delivery token, and queued until the shell reports ready.


LOGIN_WINDOW_SENDER = "system.loginwindow"


class LaunchIntent(enum.Enum):
    LOGIN_ITEM_LAUNCH = "loginItemLaunch"
    USER_COLD_OPEN = "userColdOpen"
    USER_REOPEN = "userReopen"


@dataclasses.dataclass(frozen=True)
class LaunchEvent:
    """Transport-agnostic launch notification.

    kind: "open" (first activation) or "reopen" (activate-while-running);
    anything else classifies to no intent. delivery_id identifies ONE
    delivery for dedup — redelivery of the same id must not re-present."""

    kind: str
    sender: Optional[str] = None
    login_item_marker: bool = False
    delivery_id: Optional[object] = None


def classify_launch(event: LaunchEvent) -> Optional[LaunchIntent]:
    if event.kind not in ("open", "reopen"):
        return None
    if event.login_item_marker or event.sender == LOGIN_WINDOW_SENDER:
        return LaunchIntent.LOGIN_ITEM_LAUNCH
    return (LaunchIntent.USER_COLD_OPEN if event.kind == "open"
            else LaunchIntent.USER_REOPEN)


class WindowAction(enum.Enum):
    NONE = "none"
    SETUP = "setup"
    SETTINGS = "settings"


def window_action(intent: LaunchIntent, setup_complete: bool,
                  setup_deferred: bool = False) -> WindowAction:
    """Surface for an intent. Menu-bar visibility never changes routing
    (ref ProductSurfaceTests.swift:21-62)."""
    if intent == LaunchIntent.LOGIN_ITEM_LAUNCH:
        return WindowAction.NONE
    if not setup_complete and not setup_deferred:
        return WindowAction.SETUP
    return WindowAction.SETTINGS


@dataclasses.dataclass(frozen=True)
class PendingLaunchAction:
    intent: LaunchIntent
    action: WindowAction


class LaunchWindowCoordinator:
    """Dedup + readiness queue over window_action.

    - the same delivery token presents at most once, even across repeated
      intents (ref :263-330)
    - events arriving before the shell is ready queue and resolve at drain
      time against the THEN-current onboarding state (ref :229-262)
    """

    def __init__(self) -> None:
        self._seen: set = set()
        self._queued: List[LaunchIntent] = []

    def action(self, intent: LaunchIntent, setup_complete: bool,
               setup_deferred: bool = False, ready: bool = True,
               delivery_id: Optional[object] = None) -> WindowAction:
        if delivery_id is not None:
            if delivery_id in self._seen:
                return WindowAction.NONE
            self._seen.add(delivery_id)
        if not ready:
            self._queued.append(intent)
            return WindowAction.NONE
        return window_action(intent, setup_complete, setup_deferred)

    def drain_pending_actions(
        self, setup_complete: bool, setup_deferred: bool = False
    ) -> List[PendingLaunchAction]:
        queued, self._queued = self._queued, []
        return [
            PendingLaunchAction(
                intent, window_action(intent, setup_complete, setup_deferred)
            )
            for intent in queued
        ]


# --- termination policy --------------------------------------------------------------


class TerminationReply(enum.Enum):
    NOW = "terminateNow"
    CANCEL = "terminateCancel"


class ApplicationLifecycle:
    """Termination policy (ref ProductSurfaceTests.swift:131-168):

    - unsolicited termination requests are CANCELLED (the runtime owns
      teardown; nothing may kill the audio path out from under it)
    - an update relaunch pre-authorizes exactly ONE termination reply
    - an explicit user quit requests termination itself (once) and
      authorizes the reply that follows
    """

    def __init__(self, terminate=None) -> None:
        self._terminate = terminate or (lambda: None)
        self.terminate_call_count = 0
        self._authorized = False

    def begin_update_relaunch_termination(self) -> None:
        self._authorized = True

    def request_explicit_quit(self) -> None:
        self._authorized = True
        self.terminate_call_count += 1
        self._terminate()

    def termination_reply(self) -> TerminationReply:
        if self._authorized:
            self._authorized = False  # one-shot
            return TerminationReply.NOW
        return TerminationReply.CANCEL
