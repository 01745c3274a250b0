"""Recording fakes for runtime tests (and fault injection).

Port of airwave_tpu/runtime/fakes.py, the same host code: the port keeps its
own copy and imports no module of the JAX package.

The reference's strongest test pattern (SURVEY.md §4): everything
hardware-shaped hides behind a protocol with a recording fake that records
event order, injects failures at specific points (including teardown
failures), and precondition-enforces teardown ordering
(ref AirwaveTests/AudioPipelineTests.swift:332-439,
AudioRuntimeControllerTests.swift:568-686). Exported from the library —
downstream users get the same fault-injection surface.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

from airwave_tpu_torch.runtime.transport import (
    AggregateHandle,
    ErrorKind,
    IOHandle,
    OutputDeviceDescriptor,
    StreamFormat,
    StreamTapRequest,
    TapHandle,
    TransportError,
)

FAILURE_POINTS = (
    "create_tap",
    "create_aggregate",
    "create_io",
    "start_io",
    "stop_io",
    "destroy_io",
    "destroy_aggregate",
    "destroy_tap",
)


class RecordingTransport:
    """Records every transport event; injects failures on demand."""

    def __init__(
        self,
        default_output: Optional[OutputDeviceDescriptor] = None,
        tap_format: Optional[StreamFormat] = None,
        aggregate_format: Optional[StreamFormat] = None,
        capture_access: str = "granted",
    ) -> None:
        self.default_output = default_output
        self.tap_format = tap_format
        self.aggregate_format = aggregate_format
        self.capture_access = capture_access
        self.devices: List[OutputDeviceDescriptor] = (
            [default_output] if default_output else []
        )

        self.events: List[str] = []
        self.failure_point: Optional[str] = None
        self.teardown_failures_remaining: Dict[str, int] = {}
        self.live: Dict[str, set] = {"tap": set(), "aggregate": set(), "io": set()}
        self.io_running: set = set()
        self.callbacks: Dict[int, Callable] = {}
        self._ids = itertools.count(1)
        self._default_observers: List[Callable] = []
        self._list_observers: List[Callable] = []
        self.access_requests: List[Callable] = []

    # --- fault injection helpers -------------------------------------------------

    def _check_failure(self, point: str, kind: ErrorKind) -> None:
        self.events.append(point)
        if self.failure_point == point:
            raise TransportError(kind, f"injected failure at {point}")
        remaining = self.teardown_failures_remaining.get(point, 0)
        if remaining > 0:
            self.teardown_failures_remaining[point] = remaining - 1
            raise TransportError(ErrorKind.TEARDOWN_FAILED,
                                 f"injected teardown failure at {point}")

    # --- lifecycle -----------------------------------------------------------------

    def create_tap(self, request: StreamTapRequest) -> TapHandle:
        self._check_failure("create_tap", ErrorKind.TAP_CREATION_FAILED)
        fmt = self.tap_format or StreamFormat(
            request.output.nominal_sample_rate, 2
        )
        handle = TapHandle(next(self._ids), fmt)
        self.live["tap"].add(handle.id)
        return handle

    def create_aggregate(self, tap: TapHandle) -> AggregateHandle:
        assert tap.id in self.live["tap"], "aggregate requires a live tap"
        self._check_failure("create_aggregate", ErrorKind.AGGREGATE_CREATION_FAILED)
        fmt = self.aggregate_format or tap.format
        handle = AggregateHandle(next(self._ids), fmt)
        self.live["aggregate"].add(handle.id)
        return handle

    def create_io(self, aggregate: AggregateHandle, callback) -> IOHandle:
        assert aggregate.id in self.live["aggregate"], "io requires a live aggregate"
        self._check_failure("create_io", ErrorKind.IO_SETUP_FAILED)
        handle = IOHandle(next(self._ids))
        self.live["io"].add(handle.id)
        self.callbacks[handle.id] = callback
        return handle

    def start_io(self, io: IOHandle) -> None:
        assert io.id in self.live["io"]
        self._check_failure("start_io", ErrorKind.IO_START_FAILED)
        self.io_running.add(io.id)

    def stop_io(self, io: IOHandle) -> None:
        assert io.id in self.live["io"]
        self._check_failure("stop_io", ErrorKind.TEARDOWN_FAILED)
        self.io_running.discard(io.id)

    def destroy_io(self, io: IOHandle) -> None:
        assert io.id in self.live["io"]
        assert io.id not in self.io_running, "destroy_io while running"
        self._check_failure("destroy_io", ErrorKind.TEARDOWN_FAILED)
        self.live["io"].discard(io.id)
        self.callbacks.pop(io.id, None)

    def destroy_aggregate(self, aggregate: AggregateHandle) -> None:
        assert aggregate.id in self.live["aggregate"]
        assert not self.live["io"], "aggregate destroyed before io"
        self._check_failure("destroy_aggregate", ErrorKind.TEARDOWN_FAILED)
        self.live["aggregate"].discard(aggregate.id)

    def destroy_tap(self, tap: TapHandle) -> None:
        assert tap.id in self.live["tap"]
        assert not self.live["aggregate"], "tap destroyed before aggregate"
        self._check_failure("destroy_tap", ErrorKind.TEARDOWN_FAILED)
        self.live["tap"].discard(tap.id)

    # --- discovery --------------------------------------------------------------------

    def default_output_device(self):
        return self.default_output

    def observe_default_output(self, callback) -> None:
        self._default_observers.append(callback)

    def list_output_devices(self):
        return list(self.devices)

    def observe_device_list(self, callback) -> None:
        self._list_observers.append(callback)

    def capture_access_status(self) -> str:
        return self.capture_access

    def request_capture_access(self, completion) -> None:
        self.access_requests.append(completion)

    # --- test controls --------------------------------------------------------------------

    def set_default_output_for_test(self, output) -> None:
        self.default_output = output
        for observer in list(self._default_observers):
            observer(output)

    def set_devices_for_test(self, devices) -> None:
        self.devices = list(devices)
        for observer in list(self._list_observers):
            observer(list(devices))

    def drive_callback(self, x):
        """Push one input block through the (single) live io callback."""
        assert len(self.callbacks) == 1, "expected exactly one live io"
        (callback,) = self.callbacks.values()
        return callback(x)

    @property
    def all_released(self) -> bool:
        return not any(self.live.values())


class ProbePlayerFake:
    def __init__(self) -> None:
        self.playing = False
        self.play_count = 0

    def play(self) -> None:
        self.playing = True
        self.play_count += 1

    def stop(self) -> None:
        self.playing = False


class ProfilePreparerFake:
    def __init__(self, result=None) -> None:
        self.result = result
        self.prepare_calls: List[OutputDeviceDescriptor] = []
        self.pending: List[Callable] = []
        self.auto_complete = True
        self.equalizer_definition = None

    def prepare(self, output, completion) -> None:
        self.prepare_calls.append(output)
        if self.auto_complete:
            completion(self.result)
        else:
            self.pending.append(completion)

    def current_equalizer_definition(self):
        return self.equalizer_definition

    def complete_pending(self) -> None:
        for completion in self.pending:
            completion(self.result)
        self.pending.clear()


class EffectGraphFake:
    def __init__(self) -> None:
        self.update_calls: List = []
        self.warning = None

    def update_equalizer(self, definition):
        import dataclasses

        self.update_calls.append(definition)

        @dataclasses.dataclass
        class R:
            runnable_effects: frozenset
            equalizer_warning: object

        return R(frozenset({"spatial"}), self.warning)
