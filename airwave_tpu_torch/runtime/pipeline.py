"""Stream pipeline: strict tap -> aggregate -> io lifecycle with retryable teardown.

Port of airwave_tpu/runtime/pipeline.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.

Re-implements Airwave/AudioPipeline.swift:96-224:
  - start() validates the output (supported profile), acquires tap ->
    aggregate -> io in order, validating stereo formats at the output rate
    with the 0.5 Hz tolerance at each stage, then starts I/O; any failure
    unwinds exactly the resources acquired so far, in reverse order
  - purpose-driven behavior: .verification = source stays audible + silent
    render + signal handler; .processing = source muted + DSP render
  - stop() tears down io -> aggregate -> tap; a failed stop PRESERVES the
    whole chain so a later retry can finish the teardown; stop is idempotent
"""

from __future__ import annotations

from typing import Callable, Optional

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.runtime.transport import (
    AggregateHandle,
    ErrorKind,
    IOHandle,
    OutputDeviceDescriptor,
    StreamFormat,
    StreamTapRequest,
    StreamTransport,
    TapHandle,
    TapPurpose,
    TransportError,
)


class StreamPipeline:
    def __init__(
        self,
        transport: StreamTransport,
        processor: Callable,  # StereoAudioProcessing-like: process(x)->y
        config: AirwaveConfig = DEFAULT_CONFIG,
    ) -> None:
        self.transport = transport
        self.processor = processor
        self.config = config
        self._tap: Optional[TapHandle] = None
        self._aggregate: Optional[AggregateHandle] = None
        self._io: Optional[IOHandle] = None
        self._running = False
        self.purpose: Optional[TapPurpose] = None

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def has_resources(self) -> bool:
        return any(h is not None for h in (self._tap, self._aggregate, self._io))

    def start(
        self,
        output: OutputDeviceDescriptor,
        purpose: TapPurpose,
        verification_handler: Optional[Callable[[float, int], None]] = None,
    ) -> None:
        if not output.is_supported_profile_output:
            raise TransportError(
                ErrorKind.UNSUPPORTED_OUTPUT,
                f"output {output.uid!r} is not a supported profile output",
            )
        expected = StreamFormat(output.nominal_sample_rate, 2)
        self.purpose = purpose

        try:
            self._tap = self.transport.create_tap(
                StreamTapRequest(output=output, purpose=purpose)
            )
            if not self._tap.format.matches(
                expected, self.config.sample_rate_tolerance_hz
            ):
                raise TransportError(
                    ErrorKind.FORMAT_MISMATCH,
                    f"tap format {self._tap.format} != {expected}",
                )

            self._aggregate = self.transport.create_aggregate(self._tap)
            if not self._aggregate.format.matches(
                expected, self.config.sample_rate_tolerance_hz
            ):
                raise TransportError(
                    ErrorKind.FORMAT_MISMATCH,
                    f"aggregate format {self._aggregate.format} != {expected}",
                )

            callback = self._make_callback(purpose, verification_handler)
            self._io = self.transport.create_io(self._aggregate, callback)
            self.transport.start_io(self._io)
            self._running = True
        except Exception:
            self._unwind()
            raise

    def _make_callback(self, purpose, verification_handler):
        import numpy as np

        if purpose == TapPurpose.VERIFICATION:
            def verification_callback(x):
                if verification_handler is not None:
                    peak = float(np.max(np.abs(x))) if x.size else 0.0
                    verification_handler(peak, x.shape[-1])
                return np.zeros_like(x)  # unmuted source, silent render
            return verification_callback

        def processing_callback(x):
            return self.processor(x)
        return processing_callback

    def _unwind(self) -> None:
        """Reverse-order unwind during a failed start; teardown failures here
        are swallowed (start already failed)."""
        for handle, destroy in (
            (self._io, self._destroy_io_full),
            (self._aggregate, self.transport.destroy_aggregate),
            (self._tap, self.transport.destroy_tap),
        ):
            if handle is not None:
                try:
                    destroy(handle)
                except Exception:
                    pass
        self._io = self._aggregate = self._tap = None
        self._running = False

    def _destroy_io_full(self, io: IOHandle) -> None:
        if self._running:
            try:
                self.transport.stop_io(io)
            finally:
                self._running = False
        self.transport.destroy_io(io)

    def stop(self) -> None:
        """Teardown io -> aggregate -> tap. A failure preserves the whole
        chain for a later retry (ref AudioPipeline.swift:204-223). Idempotent."""
        if not self.has_resources:
            self._running = False
            return
        if self._io is not None:
            if self._running:
                self.transport.stop_io(self._io)
                self._running = False
            self.transport.destroy_io(self._io)
            self._io = None
        if self._aggregate is not None:
            self.transport.destroy_aggregate(self._aggregate)
            self._aggregate = None
        if self._tap is not None:
            self.transport.destroy_tap(self._tap)
            self._tap = None
