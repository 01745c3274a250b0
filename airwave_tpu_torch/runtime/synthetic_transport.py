"""Synthetic stream transport: a real (non-fake) StreamTransport for headless
deployments, demos, and soak tests.

Port of airwave_tpu/runtime/synthetic_transport.py, the same host code: the
port keeps its own copy and imports no module of the JAX package.

Where the reference's transport is the CoreAudio tap->aggregate->HAL chain,
this one synthesizes its capture signal (test tone + noise) and lets the host
pump the render callback at its own cadence — the deployment seam a socket-
or file-backed transport would also implement.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np

from airwave_tpu_torch.runtime.transport import (
    AggregateHandle,
    IOHandle,
    OutputDeviceDescriptor,
    StreamFormat,
    StreamTapRequest,
    TapHandle,
)


class SyntheticTransport:
    def __init__(self, output: OutputDeviceDescriptor,
                 tone_hz: float = 440.0, amplitude: float = 0.3,
                 batch: int = 1) -> None:
        self.output = output
        self.tone_hz = tone_hz
        self.amplitude = amplitude
        self.batch = batch
        self._ids = itertools.count(1)
        self._callbacks: Dict[int, Callable] = {}
        self._running: set = set()
        self._default_observers: List[Callable] = []
        self._list_observers: List[Callable] = []
        self._phase = 0
        self.frames_pumped = 0
        self.last_output: Optional[np.ndarray] = None
        self._probe_buffer: Optional[np.ndarray] = None
        self._probe_cursor = 0

    # --- lifecycle --------------------------------------------------------------

    def create_tap(self, request: StreamTapRequest) -> TapHandle:
        fmt = StreamFormat(request.output.nominal_sample_rate, 2)
        return TapHandle(next(self._ids), fmt)

    def create_aggregate(self, tap: TapHandle) -> AggregateHandle:
        return AggregateHandle(next(self._ids), tap.format)

    def create_io(self, aggregate: AggregateHandle, callback) -> IOHandle:
        handle = IOHandle(next(self._ids))
        self._callbacks[handle.id] = callback
        return handle

    def start_io(self, io: IOHandle) -> None:
        self._running.add(io.id)

    def stop_io(self, io: IOHandle) -> None:
        self._running.discard(io.id)

    def destroy_io(self, io: IOHandle) -> None:
        # Hosts may destroy without an explicit stop (the protocol puts no
        # ordering precondition on direct callers); never leave a running
        # id whose callback is gone.
        self._running.discard(io.id)
        self._callbacks.pop(io.id, None)

    def destroy_aggregate(self, aggregate: AggregateHandle) -> None:
        pass

    def destroy_tap(self, tap: TapHandle) -> None:
        pass

    # --- discovery ----------------------------------------------------------------

    def default_output_device(self):
        return self.output

    def observe_default_output(self, callback) -> None:
        self._default_observers.append(callback)

    def list_output_devices(self):
        return [self.output]

    def observe_device_list(self, callback) -> None:
        self._list_observers.append(callback)

    def capture_access_status(self) -> str:
        return "granted"

    def request_capture_access(self, completion) -> None:
        completion(True)

    # --- probe sink (CaptureProbe plays through the capture path) --------------------

    def play_buffer(self, audio: np.ndarray, sample_rate: float) -> None:
        self._probe_buffer = np.asarray(audio, np.float32)
        self._probe_cursor = 0

    def stop_buffer(self) -> None:
        self._probe_buffer = None
        self._probe_cursor = 0

    # --- pumping --------------------------------------------------------------------

    def pump(self, frames: int) -> Optional[np.ndarray]:
        """Generate `frames` of stereo test signal and run the live callback."""
        if not self._running:
            return None
        rate = self.output.nominal_sample_rate
        t = (self._phase + np.arange(frames)) / rate
        tone = np.sin(2 * np.pi * self.tone_hz * t)
        signal = (self.amplitude * tone).astype(np.float32)
        self._phase += frames
        self.frames_pumped += frames
        x = np.tile(signal[None, None, :], (self.batch, 2, 1))
        if self._probe_buffer is not None:
            take = min(frames, self._probe_buffer.shape[1] - self._probe_cursor)
            if take > 0:
                x[:, :, :take] += self._probe_buffer[
                    None, :, self._probe_cursor:self._probe_cursor + take
                ]
                self._probe_cursor += take
            else:
                self._probe_buffer = None
        if len(self._running) != 1:
            raise RuntimeError(
                f"pump needs exactly one running io, have "
                f"{len(self._running)} — wire one SyntheticTransport per "
                f"pipeline"
            )
        (callback,) = (self._callbacks[io] for io in self._running)
        out = callback(x)
        self.last_output = np.asarray(out)
        return self.last_output
