"""Stream transport boundary: capability-oriented I/O seam + policies.

Port of airwave_tpu/runtime/transport.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.

The headless analog of Airwave/AudioPlatformClient.swift
(:23-226): value types (output descriptors with the supported-profile policy,
stream formats with 0.5 Hz tolerance, capture-signal verification policy),
a typed error taxonomy, and a deliberately *capability-limited* transport
protocol — it can observe devices and own a capture->render chain but, by
design, has **no route/volume mutation** (ref :191; enforced by a
source-scanning contract test like the reference's
AudioPipelineTests.swift:268-274).

In the reference the transport is the CoreAudio process-tap -> private
aggregate -> HAL I/O chain; here it is whatever feeds blocks into the device
render loop (synthetic generators, file streams, sockets). The three-handle
lifecycle (tap -> aggregate -> io) is kept so the orchestration layer's
acquire/unwind/teardown-retry semantics carry over unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Protocol

from airwave_tpu_torch.config import DEFAULT_CONFIG

# --- value types ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OutputDeviceDescriptor:
    uid: str
    name: str = ""
    transport_type: str = "builtin"
    nominal_sample_rate: float = 48_000.0
    channel_count: int = 2
    is_virtual: bool = False
    is_aggregate: bool = False

    @property
    def is_supported_profile_output(self) -> bool:
        """Policy: non-empty UID, not virtual/aggregate, exactly 2 channels
        (ref AudioPlatformClient.swift:23-39)."""
        return (
            bool(self.uid)
            and not self.is_virtual
            and not self.is_aggregate
            and self.channel_count == 2
        )


@dataclasses.dataclass(frozen=True)
class StreamFormat:
    sample_rate: float
    channel_count: int

    def matches(self, other: "StreamFormat",
                tolerance_hz: float = DEFAULT_CONFIG.sample_rate_tolerance_hz) -> bool:
        """0.5 Hz rate tolerance (ref AudioPlatformClient.swift:72-81)."""
        return (
            self.channel_count == other.channel_count
            and abs(self.sample_rate - other.sample_rate) <= tolerance_hz
        )


class ErrorKind(enum.Enum):
    PERMISSION_DENIED = "permissionDenied"
    TAP_CREATION_FAILED = "tapCreationFailed"
    AGGREGATE_CREATION_FAILED = "aggregateCreationFailed"
    IO_SETUP_FAILED = "ioSetupFailed"
    IO_START_FAILED = "ioStartFailed"
    FORMAT_MISMATCH = "formatMismatch"
    UNSUPPORTED_OUTPUT = "unsupportedOutput"
    DEVICE_LOST = "deviceLost"
    RENDER_FAILURE = "renderFailure"
    TEARDOWN_FAILED = "teardownFailed"


class TransportError(Exception):
    def __init__(self, kind: ErrorKind, detail: str = ""):
        self.kind = kind
        self.detail = detail
        super().__init__(f"{kind.value}: {detail}" if detail else kind.value)


class TapPurpose(enum.Enum):
    """Mute behavior by purpose (ref AudioPipeline.swift:177-194):
    verification leaves the source audible and renders silence;
    processing mutes the tapped source and renders the DSP output."""

    VERIFICATION = "verification"
    PROCESSING = "processing"


@dataclasses.dataclass(frozen=True)
class StreamTapRequest:
    output: OutputDeviceDescriptor
    purpose: TapPurpose


class CaptureSignalPolicy:
    """Capture verified after >= 2048 *sustained* frames at >= 1e-4 amplitude
    (ref AudioPlatformClient.swift:153-179). Silence resets the run."""

    def __init__(
        self,
        min_sustained_frames: int = DEFAULT_CONFIG.capture_min_sustained_frames,
        min_amplitude: float = DEFAULT_CONFIG.capture_min_amplitude,
    ) -> None:
        self.min_sustained_frames = min_sustained_frames
        self.min_amplitude = min_amplitude
        self._run = 0
        self.verified = False

    def observe(self, peak_amplitude: float, frame_count: int) -> bool:
        """Feed one callback's peak amplitude; returns True once verified."""
        if self.verified:
            return True
        if peak_amplitude >= self.min_amplitude:
            self._run += frame_count
            if self._run >= self.min_sustained_frames:
                self.verified = True
        else:
            self._run = 0
        return self.verified

    def reset(self) -> None:
        self._run = 0
        self.verified = False


# --- handles -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TapHandle:
    id: int
    format: StreamFormat


@dataclasses.dataclass(frozen=True)
class AggregateHandle:
    id: int
    format: StreamFormat


@dataclasses.dataclass(frozen=True)
class IOHandle:
    id: int


# The render callback: (input_block [B?, C, n] float32) -> output [.., 2, n].
RenderCallback = Callable[["object"], "object"]


class StreamTransport(Protocol):
    """Capability-oriented transport. DELIBERATELY ABSENT: any route/volume
    mutation (no set_default_output, no set_volume) — the framework gets out
    of the audio path rather than reconfigure the user's system."""

    # lifecycle
    def create_tap(self, request: StreamTapRequest) -> TapHandle: ...
    def create_aggregate(self, tap: TapHandle) -> AggregateHandle: ...
    def create_io(self, aggregate: AggregateHandle,
                  callback: RenderCallback) -> IOHandle: ...
    def start_io(self, io: IOHandle) -> None: ...
    def stop_io(self, io: IOHandle) -> None: ...
    def destroy_io(self, io: IOHandle) -> None: ...
    def destroy_aggregate(self, aggregate: AggregateHandle) -> None: ...
    def destroy_tap(self, tap: TapHandle) -> None: ...

    # discovery / observation
    def default_output_device(self) -> Optional[OutputDeviceDescriptor]: ...
    def observe_default_output(
        self, callback: Callable[[Optional[OutputDeviceDescriptor]], None]
    ) -> None: ...
    def list_output_devices(self) -> List[OutputDeviceDescriptor]: ...
    def observe_device_list(
        self, callback: Callable[[List[OutputDeviceDescriptor]], None]
    ) -> None: ...

    # capture access
    def capture_access_status(self) -> str: ...
    def request_capture_access(self, completion: Callable[[bool], None]) -> None: ...
