"""Runtime controller: the central state machine with generation-counted recovery.

Port of airwave_tpu/runtime/controller.py, the same host code: the port
keeps its own copy and imports no module of the JAX package.

Re-implements the observable behavior of
Airwave/AudioRuntimeController.swift:56-651:

  - generation counter: every invalidation bumps it; stale async completions
    are dropped (:379, 465-467, 489)
  - launch: observe the default output, reconcile, prepare profile, start
  - capture verification: start a verification pipeline, play a probe
    stimulus after 0.1 s, require a sustained signal within 2.5 s, then
    promote to a processing pipeline (:57, 429-483)
  - failure taxonomy -> one health issue per category + status
    (recovering / native passthrough); permission and explicit-test failures
    never auto-retry (:494-537)
  - exponential retry ladder [1, 2, 4, 8, 15] s (:79, 570-580)
  - cleanup-retry loop when teardown itself fails, preserving the resource
    chain (:582-599)
  - 30 s stability window resets the retry counter (:601-607)
  - 1 s device-loss grace period (:58, 286-301)
  - sleep/wake and terminate (:246-273)

Dependency seams (all injectable, mirroring the reference's testability):
transport, pipeline factory, effect graph, profile preparer, probe player,
scheduler, observable state.
"""

from __future__ import annotations

from typing import Callable, Optional

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.runtime.scheduler import Scheduler
from airwave_tpu_torch.runtime.state import (
    AudioRuntimeState,
    CaptureAccess,
    HealthCategory,
    RuntimeHealthIssue,
    Status,
)
from airwave_tpu_torch.runtime.transport import (
    CaptureSignalPolicy,
    ErrorKind,
    OutputDeviceDescriptor,
    TapPurpose,
    TransportError,
)


class AudioRuntimeController:
    def __init__(
        self,
        transport,
        pipeline_factory: Callable[[], "object"],
        effect_graph,
        state: Optional[AudioRuntimeState] = None,
        scheduler: Optional[Scheduler] = None,
        probe_player=None,
        config: AirwaveConfig = DEFAULT_CONFIG,
    ) -> None:
        from airwave_tpu_torch.runtime.scheduler import ThreadScheduler

        self.transport = transport
        self.pipeline_factory = pipeline_factory
        self.effect_graph = effect_graph
        self.state = state or AudioRuntimeState()
        self.scheduler = scheduler or ThreadScheduler()
        self.probe_player = probe_player
        self.config = config

        self.generation = 0
        self.current_output: Optional[OutputDeviceDescriptor] = None
        self.pipeline = None
        self.capture_verified = False
        self.profile_preparer = None  # set via set_profile_preparer
        self._retry_index = 0
        self._retry_token: Optional[int] = None
        self._stability_token: Optional[int] = None
        self._verification_timeout_token: Optional[int] = None
        self._probe_delay_token: Optional[int] = None
        self._device_loss_token: Optional[int] = None
        self._cleanup_pipelines: list = []
        self._cleanup_scheduled = False
        self._terminated = False
        self._signal_policy = CaptureSignalPolicy(
            config.capture_min_sustained_frames, config.capture_min_amplitude
        )

    # --- wiring ---------------------------------------------------------------

    def set_profile_preparer(self, preparer) -> None:
        """preparer.prepare(output, completion) -> completion(readiness dict)."""
        self.profile_preparer = preparer

    # --- lifecycle entry points -------------------------------------------------

    def launch(self) -> None:
        self.transport.observe_default_output(self._default_output_changed)
        access = self.transport.capture_access_status()
        self.state.set_capture_access(CaptureAccess(access))
        self._reconcile()

    def terminate(self) -> None:
        self._terminated = True
        self._invalidate()
        self._stop_pipeline()
        self.state.publish(Status.INACTIVE)

    def will_sleep(self) -> None:
        self._invalidate()
        self._stop_pipeline()
        self.state.publish(Status.INACTIVE)

    def did_wake(self) -> None:
        if not self._terminated:
            self._reconcile()

    def retry_now(self) -> None:
        self._cancel(self._retry_token)
        self._retry_token = None
        self._reconcile()

    def request_capture_access(self) -> None:
        generation = self.generation

        def completed(granted: bool) -> None:
            if generation != self.generation:
                return  # stale
            self.state.set_capture_access(
                CaptureAccess.GRANTED if granted else CaptureAccess.DENIED
            )
            if granted:
                self.state.set_health_issue(HealthCategory.PERMISSION, None)
                self._reconcile()
            else:
                self._fail(
                    HealthCategory.PERMISSION,
                    "System audio capture permission denied.",
                    retryable=False,
                    status=Status.NEEDS_PERMISSION,
                )

        self.transport.request_capture_access(completed)

    def update_readiness(self, invalidation: str = "full") -> None:
        """Live-EQ fast path vs full reprepare (ref :150-173)."""
        if (
            invalidation == "equalizerTarget"
            and self.pipeline is not None
            and self.pipeline.is_running
        ):
            definition = (
                self.profile_preparer.current_equalizer_definition()
                if self.profile_preparer is not None
                else None
            )
            result = self.effect_graph.update_equalizer(definition)
            self._apply_equalizer_warning(result)
            return
        self.reprepare_current_output()

    def reprepare_current_output(self) -> None:
        self._invalidate()
        self._stop_pipeline()
        self._reconcile()

    # --- core flow -----------------------------------------------------------------

    def _reconcile(self) -> None:
        if self._terminated:
            return
        output = self.transport.default_output_device()
        self.current_output = output
        if output is None:
            self.state.publish(Status.UNAVAILABLE)
            self.state.set_health_issue(
                HealthCategory.OUTPUT,
                RuntimeHealthIssue(HealthCategory.OUTPUT, "No output device."),
            )
            return
        self.state.set_health_issue(HealthCategory.OUTPUT, None)
        if not output.is_supported_profile_output:
            self._fail(
                HealthCategory.OUTPUT,
                f"Output {output.name or output.uid} is not supported.",
                retryable=False,
                status=Status.NATIVE_PASSTHROUGH,
            )
            return

        access = CaptureAccess(self.transport.capture_access_status())
        self.state.set_capture_access(access)
        if access != CaptureAccess.GRANTED:
            self.state.publish(Status.NEEDS_PERMISSION)
            self.state.set_health_issue(
                HealthCategory.PERMISSION,
                RuntimeHealthIssue(
                    HealthCategory.PERMISSION,
                    "System audio capture permission required.",
                ),
            )
            return
        self.state.set_health_issue(HealthCategory.PERMISSION, None)

        self.state.publish(Status.STARTING)
        self._prepare_and_start(output)

    def _prepare_and_start(self, output: OutputDeviceDescriptor) -> None:
        generation = self.generation

        def prepared(readiness) -> None:
            if generation != self.generation:
                return  # stale preparation dropped (ref :379)
            self._apply_equalizer_warning(readiness)
            self.start(output)

        if self.profile_preparer is not None:
            self.profile_preparer.prepare(output, prepared)
        else:
            self.start(output)

    def start(self, output: OutputDeviceDescriptor) -> None:
        """Start capture: verification first if unverified (ref :363-377)."""
        if self._terminated:
            return
        purpose = (
            TapPurpose.PROCESSING
            if self.capture_verified
            else TapPurpose.VERIFICATION
        )
        self._start_pipeline(output, purpose)

    def _start_pipeline(self, output, purpose) -> None:
        # A new pipeline always supersedes the old one; paths that reach
        # here without an explicit invalidation (retry_now -> _reconcile,
        # a redundant granted-permission completion) must not leak a live
        # chain by overwriting self.pipeline.
        self._stop_pipeline()
        generation = self.generation
        pipeline = self.pipeline_factory()
        try:
            if purpose == TapPurpose.VERIFICATION:
                self._signal_policy.reset()

                def on_signal(peak: float, frames: int) -> None:
                    if generation != self.generation:
                        return
                    if self._signal_policy.observe(peak, frames):
                        self._capture_verified(output)

                pipeline.start(output, purpose, verification_handler=on_signal)
            else:
                pipeline.start(output, purpose)
        except TransportError as err:
            self._handle_failure(err)
            return
        except Exception as err:  # noqa: BLE001
            self._handle_failure(
                TransportError(ErrorKind.IO_SETUP_FAILED, str(err))
            )
            return

        self.pipeline = pipeline
        if purpose == TapPurpose.VERIFICATION:
            self._begin_verification_window(output)
        else:
            self.state.publish(Status.PROCESSING)
            self.state.set_health_issue(HealthCategory.CAPTURE, None)
            self.state.set_health_issue(HealthCategory.PIPELINE, None)
            self.state.set_health_issue(HealthCategory.RECOVERY, None)
            self._begin_stability_window()

    # --- capture verification -------------------------------------------------------

    def _begin_verification_window(self, output) -> None:
        generation = self.generation
        if self.probe_player is not None:
            def play_probe() -> None:
                if generation == self.generation:
                    self.probe_player.play()
            self._probe_delay_token = self.scheduler.schedule(
                self.config.capture_probe_delay_seconds, play_probe
            )

        def timed_out() -> None:
            if generation != self.generation:
                return
            self._stop_probe()
            self._fail(
                HealthCategory.CAPTURE,
                "Capture verification timed out.",
                retryable=True,
            )

        self._verification_timeout_token = self.scheduler.schedule(
            self.config.capture_verification_timeout_seconds, timed_out
        )

    def _capture_verified(self, output) -> None:
        """Promote verification -> processing (ref :469-483)."""
        self._cancel(self._verification_timeout_token)
        self._verification_timeout_token = None
        self._stop_probe()
        self.capture_verified = True
        # The verification pipeline's signal handler stays live until its
        # chain is torn down (the policy reports verified forever once
        # tripped): bump the generation so late callbacks are stale
        # instead of re-running this promotion against the NEW pipeline.
        self.generation += 1
        if not self._stop_pipeline():
            # Teardown failed: the chain is preserved in the cleanup-retry
            # loop; surface a retryable failure rather than stacking a
            # processing pipeline on the still-live verification tap.
            self._fail(
                HealthCategory.PIPELINE,
                "Verification pipeline teardown failed.",
                retryable=True,
            )
            return
        self._start_pipeline(self.current_output, TapPurpose.PROCESSING)

    def _stop_probe(self) -> None:
        self._cancel(self._probe_delay_token)
        self._probe_delay_token = None
        if self.probe_player is not None:
            self.probe_player.stop()

    # --- failure handling --------------------------------------------------------------

    def render_failure(self, detail: str = "") -> None:
        """Surface a render-callback failure (ref observeRenderFailure)."""
        self._handle_failure(TransportError(ErrorKind.RENDER_FAILURE, detail))

    def _handle_failure(self, err: TransportError) -> None:
        category, retryable, status = _classify(err)
        self._fail(category, str(err), retryable=retryable, status=status)

    def _fail(
        self,
        category: HealthCategory,
        message: str,
        retryable: bool,
        status: Status = Status.RECOVERING,
    ) -> None:
        self._invalidate()
        self._stop_pipeline()
        self.state.set_health_issue(
            category, RuntimeHealthIssue(category, message)
        )
        if not retryable:
            self.state.publish(status)
            return
        if self._retry_index >= len(self.config.retry_ladder_seconds):
            self.state.publish(Status.NATIVE_PASSTHROUGH)
            self.state.set_health_issue(
                HealthCategory.RECOVERY,
                RuntimeHealthIssue(
                    HealthCategory.RECOVERY,
                    "Automatic recovery attempts exhausted.",
                ),
            )
            return
        delay = self.config.retry_ladder_seconds[self._retry_index]
        self._retry_index += 1
        self.state.publish(Status.RECOVERING)
        generation = self.generation

        def retry() -> None:
            if generation != self.generation:
                return
            self._retry_token = None
            self._reconcile()

        self._retry_token = self.scheduler.schedule(delay, retry)

    def _begin_stability_window(self) -> None:
        """30 s of stable processing resets the retry ladder (ref :601-607)."""
        generation = self.generation
        self._cancel(self._stability_token)

        def stable() -> None:
            if generation != self.generation:
                return
            self._retry_index = 0
            self.state.set_health_issue(HealthCategory.RECOVERY, None)

        self._stability_token = self.scheduler.schedule(
            self.config.stability_window_seconds, stable
        )

    # --- device observation -----------------------------------------------------------

    def _default_output_changed(self, output: Optional[OutputDeviceDescriptor]) -> None:
        if self._terminated:
            return
        if output is None:
            # 1 s grace period before treating as loss (ref :58, 286-301).
            # Duplicate loss notifications must not orphan an earlier
            # timer (a restored device would cancel only the newest).
            self._cancel(self._device_loss_token)
            generation = self.generation

            def confirm_loss() -> None:
                if generation != self.generation:
                    return
                self._device_loss_token = None
                self._invalidate()
                self._stop_pipeline()
                self._reconcile()

            self._device_loss_token = self.scheduler.schedule(
                self.config.device_loss_grace_seconds, confirm_loss
            )
            return
        self._cancel(self._device_loss_token)
        self._device_loss_token = None
        if (
            self.current_output is not None
            and output.uid == self.current_output.uid
            and self.pipeline is not None
        ):
            return  # same device, already running
        self.reprepare_current_output()

    # --- teardown / cleanup retries ------------------------------------------------------

    def _stop_pipeline(self) -> bool:
        """Stop the current pipeline. Returns True when teardown succeeded
        (or there was nothing to stop); on failure the chain is preserved
        in the cleanup-retry loop."""
        if self.pipeline is None:
            return True
        pipeline, self.pipeline = self.pipeline, None
        try:
            pipeline.stop()
            return True
        except Exception:  # teardown failed: keep the chain, retry cleanup
            # Every un-torn-down chain is kept (a second failure must not
            # orphan the first one's resources).
            self._cleanup_pipelines.append(pipeline)
            self._schedule_cleanup_retry()
            return False

    def _schedule_cleanup_retry(self) -> None:
        if self._cleanup_scheduled:
            return
        self._cleanup_scheduled = True

        def cleanup() -> None:
            self._cleanup_scheduled = False
            remaining = []
            for pipeline in self._cleanup_pipelines:
                try:
                    pipeline.stop()
                except Exception:
                    remaining.append(pipeline)
            self._cleanup_pipelines = remaining
            if remaining:
                self._schedule_cleanup_retry()

        self.scheduler.schedule(1.0, cleanup)

    # --- helpers ------------------------------------------------------------------------

    def _invalidate(self) -> None:
        self.generation += 1
        for token_attr in (
            "_retry_token",
            "_verification_timeout_token",
            "_probe_delay_token",
            "_device_loss_token",
            "_stability_token",
        ):
            self._cancel(getattr(self, token_attr))
            setattr(self, token_attr, None)

    def _cancel(self, token: Optional[int]) -> None:
        if token is not None:
            self.scheduler.cancel(token)

    def _apply_equalizer_warning(self, result) -> None:
        warning = getattr(result, "equalizer_warning", None)
        self.state.set_health_issue(
            HealthCategory.EQUALIZER,
            RuntimeHealthIssue(HealthCategory.EQUALIZER, str(warning))
            if warning is not None
            else None,
        )
        spatial_ready = SPATIAL_READY_UNKNOWN
        runnable = getattr(result, "runnable_effects", None)
        if runnable is not None:
            spatial_ready = "spatial" in runnable
        if spatial_ready is not SPATIAL_READY_UNKNOWN:
            self.state.set_health_issue(
                HealthCategory.SPATIAL,
                None
                if spatial_ready
                else RuntimeHealthIssue(
                    HealthCategory.SPATIAL, "Spatial renderer not ready."
                ),
            )


SPATIAL_READY_UNKNOWN = object()


def _classify(err: TransportError):
    """Failure taxonomy -> (health category, retryable, terminal status)."""
    kind = err.kind
    if kind == ErrorKind.PERMISSION_DENIED:
        return HealthCategory.PERMISSION, False, Status.NEEDS_PERMISSION
    if kind == ErrorKind.UNSUPPORTED_OUTPUT:
        return HealthCategory.OUTPUT, False, Status.NATIVE_PASSTHROUGH
    if kind in (ErrorKind.TAP_CREATION_FAILED, ErrorKind.FORMAT_MISMATCH):
        return HealthCategory.CAPTURE, True, Status.RECOVERING
    if kind in (
        ErrorKind.AGGREGATE_CREATION_FAILED,
        ErrorKind.IO_SETUP_FAILED,
        ErrorKind.IO_START_FAILED,
        ErrorKind.RENDER_FAILURE,
    ):
        return HealthCategory.PIPELINE, True, Status.RECOVERING
    if kind == ErrorKind.DEVICE_LOST:
        return HealthCategory.OUTPUT, True, Status.RECOVERING
    return HealthCategory.PIPELINE, True, Status.RECOVERING
