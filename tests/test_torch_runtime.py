"""The port's live runtime against the JAX package's: the pipeline, the
controller state machine, the capture probe and the shell's presentation
and launch policies.

Every case of tests/test_runtime.py, the two probe cases of
tests/test_probe_and_feeder.py and the presentation and launch-policy
cases of tests/test_shell.py run twice, once on each package's own
classes (its controller, pipeline, scheduler and recording fakes: a JAX
fake's descriptors are other classes), through the same scripted
ManualScheduler timeline and fault injections. Each run keeps its
assertions and returns a trace: the status trail, the health issues
(category and text) and the transport's event log. The two traces must be
equal.
"""

import importlib
import inspect
import types

import numpy as np
import pytest

_MODULES = {
    "controller": "runtime.controller",
    "fakes": "runtime.fakes",
    "pipeline": "runtime.pipeline",
    "scheduler": "runtime.scheduler",
    "state": "runtime.state",
    "transport": "runtime.transport",
    "probe": "runtime.probe",
    "synthetic": "runtime.synthetic_transport",
    "pres": "shell.presentation",
}


def _package(root: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        key: importlib.import_module(f"{root}.{name}")
        for key, name in _MODULES.items()})


PACKAGES = {"jax": _package("airwave_tpu"),
            "torch": _package("airwave_tpu_torch")}


def doubler(x):
    return np.asarray(x)[:, :2, :] * 2.0


def output(P, **kw):
    kw.setdefault("uid", "dev-1")
    kw.setdefault("name", "Speakers")
    kw.setdefault("nominal_sample_rate", 48_000.0)
    return P.transport.OutputDeviceDescriptor(**kw)


def issues(state) -> list:
    return [(i.category.name, i.message) for i in state.health_issues]


def run_both(scenario, *args):
    """Run `scenario(P, *args)` on each package; the traces must agree."""
    traces = {name: scenario(P, *args) for name, P in PACKAGES.items()}
    assert traces["torch"] == traces["jax"]
    return traces["torch"]


# --- pipeline ------------------------------------------------------------------


def pipeline_acquire_order_and_stop_order(P):
    out = output(P)
    t = P.fakes.RecordingTransport(out)
    p = P.pipeline.StreamPipeline(t, doubler)
    p.start(out, P.transport.TapPurpose.PROCESSING)
    assert t.events == ["create_tap", "create_aggregate", "create_io",
                        "start_io"]
    assert p.is_running
    p.stop()
    assert t.events[4:] == ["stop_io", "destroy_io", "destroy_aggregate",
                            "destroy_tap"]
    assert t.all_released
    p.stop()  # idempotent
    assert t.events[8:] == []
    return t.events


def pipeline_unwind(point, expected_after):
    def scenario(P):
        out = output(P)
        t = P.fakes.RecordingTransport(out)
        t.failure_point = point
        p = P.pipeline.StreamPipeline(t, doubler)
        with pytest.raises(P.transport.TransportError) as exc:
            p.start(out, P.transport.TapPurpose.PROCESSING)
        assert t.all_released
        idx = t.events.index(point)
        assert t.events[idx + 1:] == expected_after
        assert not p.has_resources
        return t.events, exc.value.kind.value, str(exc.value)
    scenario.__name__ = f"pipeline_unwinds_at_{point}"
    return scenario


def pipeline_rejects_unsupported_output_and_format_mismatch(P):
    out = output(P)
    t = P.fakes.RecordingTransport(out)
    p = P.pipeline.StreamPipeline(t, doubler)
    kinds = []
    with pytest.raises(P.transport.TransportError) as exc:
        p.start(P.transport.OutputDeviceDescriptor(uid="agg",
                                                   is_aggregate=True),
                P.transport.TapPurpose.PROCESSING)
    assert exc.value.kind == P.transport.ErrorKind.UNSUPPORTED_OUTPUT
    kinds.append(str(exc.value))
    t2 = P.fakes.RecordingTransport(
        out, tap_format=P.transport.StreamFormat(44_100.0, 2))
    p2 = P.pipeline.StreamPipeline(t2, doubler)
    with pytest.raises(P.transport.TransportError) as exc:
        p2.start(out, P.transport.TapPurpose.PROCESSING)
    assert exc.value.kind == P.transport.ErrorKind.FORMAT_MISMATCH
    assert t2.all_released
    kinds.append(exc.value.kind.value)
    return kinds, t.events, t2.events


def pipeline_failed_teardown_preserves_chain_for_retry(P):
    out = output(P)
    t = P.fakes.RecordingTransport(out)
    p = P.pipeline.StreamPipeline(t, doubler)
    p.start(out, P.transport.TapPurpose.PROCESSING)
    t.teardown_failures_remaining["stop_io"] = 1
    with pytest.raises(P.transport.TransportError):
        p.stop()
    assert p.has_resources  # chain preserved
    p.stop()  # retry succeeds
    assert t.all_released
    return t.events


def pipeline_purpose_driven_callback_behavior(P):
    out = output(P)
    t = P.fakes.RecordingTransport(out)
    signals = []
    p = P.pipeline.StreamPipeline(t, doubler)
    p.start(out, P.transport.TapPurpose.VERIFICATION,
            verification_handler=lambda peak, n: signals.append((peak, n)))
    x = np.full((1, 2, 64), 0.25, np.float32)
    silent = t.drive_callback(x)
    np.testing.assert_array_equal(silent, 0)  # silent render, source audible
    assert signals == [(0.25, 64)]
    p.stop()
    p2 = P.pipeline.StreamPipeline(t, doubler)
    p2.start(out, P.transport.TapPurpose.PROCESSING)
    doubled = t.drive_callback(x)
    np.testing.assert_allclose(doubled, 0.5)
    p2.stop()
    return t.events, signals, silent.tolist(), doubled.tolist()


def transport_protocol_has_no_route_or_volume_mutation(P):
    """Source-scanning contract (ref AudioPipelineTests.swift:268-274)."""
    source = inspect.getsource(P.transport)
    defs = [line.strip() for line in source.splitlines()
            if line.strip().startswith("def ")]
    for forbidden in ("set_default_output", "setDefaultOutput", "set_volume",
                      "setVolume", "set_mute", "route_change"):
        assert not any(forbidden in d for d in defs), forbidden
    return defs


# --- controller -----------------------------------------------------------------


class Harness:
    def __init__(self, P, capture_access="granted", out=None):
        self.P = P
        self.output = out or output(P)
        self.transport = P.fakes.RecordingTransport(
            self.output, capture_access=capture_access)
        self.scheduler = P.scheduler.ManualScheduler()
        self.state = P.state.AudioRuntimeState()
        self.probe = P.fakes.ProbePlayerFake()
        self.preparer = P.fakes.ProfilePreparerFake()
        self.graph = P.fakes.EffectGraphFake()
        self.statuses = []
        self.state.observe(lambda s: self.statuses.append(s.status.value))
        self.controller = P.controller.AudioRuntimeController(
            transport=self.transport,
            pipeline_factory=lambda: P.pipeline.StreamPipeline(
                self.transport, doubler),
            effect_graph=self.graph,
            state=self.state,
            scheduler=self.scheduler,
            probe_player=self.probe,
        )
        self.controller.set_profile_preparer(self.preparer)

    def drive_signal(self, amplitude=0.5, frames=4096):
        x = np.full((1, 2, frames), amplitude, np.float32)
        return self.transport.drive_callback(x)

    @property
    def status(self):
        return self.state.status.value

    def has_issue(self, category: str) -> bool:
        return any(i.category.name == category
                   for i in self.state.health_issues)

    def trace(self, *extra):
        return (self.statuses, issues(self.state), self.transport.events,
                self.scheduler.now, self.probe.play_count, *extra)


def launch_verifies_then_promotes_to_processing(P):
    h = Harness(P)
    h.controller.launch()
    assert h.status == "starting"
    assert h.controller.pipeline.purpose.value == "verification"
    assert not h.probe.playing  # the probe plays after 0.1 s
    h.scheduler.advance(0.15)
    assert h.probe.playing
    h.drive_signal()  # sustained signal -> promotion
    assert h.status == "processing"
    assert h.controller.pipeline.purpose.value == "processing"
    assert not h.probe.playing
    assert h.controller.capture_verified
    return h.trace()


def quiet_signal_does_not_verify(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal(amplitude=1e-5)
    assert h.status == "starting"
    # Silence resets the sustained run.
    h.drive_signal(amplitude=0.5, frames=1024)
    h.drive_signal(amplitude=0.0, frames=64)
    h.drive_signal(amplitude=0.5, frames=1024)
    assert h.status == "starting"
    h.drive_signal(amplitude=0.5, frames=1024)
    assert h.status == "processing"
    return h.trace()


def verification_timeout_schedules_retry_ladder_then_passthrough(P):
    h = Harness(P)
    h.controller.launch()
    for expected_delay in [1, 2, 4, 8, 15]:
        h.scheduler.advance(2.5)  # timeout fires
        assert h.status == "recovering"
        assert h.has_issue("CAPTURE")
        h.scheduler.advance(expected_delay)  # the retry restarts verification
        assert h.status == "starting"
    h.scheduler.advance(2.5)  # 6th timeout: ladder exhausted
    assert h.status == "nativePassthrough"
    assert h.has_issue("RECOVERY")
    return h.trace()


def stale_preparation_completion_is_dropped(P):
    h = Harness(P)
    h.preparer.auto_complete = False
    h.controller.launch()
    assert len(h.preparer.pending) == 1
    h.controller.reprepare_current_output()  # bumps generation; re-prepares
    assert len(h.preparer.pending) == 2
    h.preparer.pending.pop(0)(None)  # stale: must not start a pipeline
    assert h.controller.pipeline is None
    h.preparer.pending.pop(0)(None)  # current completion starts it
    assert h.controller.pipeline is not None
    return h.trace()


def permission_denied_never_auto_retries(P):
    h = Harness(P, capture_access="denied")
    h.controller.launch()
    assert h.status == "needsPermission"
    assert h.scheduler.pending == []  # no retry scheduled
    h.controller.request_capture_access()
    h.transport.capture_access = "granted"
    h.transport.access_requests.pop()(True)
    assert h.status == "starting"
    return h.trace(h.state.capture_access.value)


def unsupported_output_is_native_passthrough_without_retry(P):
    h = Harness(P, out=P.transport.OutputDeviceDescriptor(uid="virt",
                                                          is_virtual=True))
    h.controller.launch()
    assert h.status == "nativePassthrough"
    assert h.scheduler.pending == []
    return h.trace()


def pipeline_start_failure_retries_and_stability_resets_ladder(P):
    h = Harness(P)
    h.transport.failure_point = "start_io"
    h.controller.launch()
    assert h.status == "recovering"
    assert h.controller._retry_index == 1
    h.transport.failure_point = None
    h.scheduler.advance(1.0)  # retry 1 succeeds -> verification
    h.drive_signal()
    assert h.status == "processing"
    h.scheduler.advance(30.0)  # stability window
    assert h.controller._retry_index == 0
    return h.trace()


def device_loss_grace_period(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    assert h.status == "processing"
    events_before = len(h.transport.events)
    # Momentary loss restored within 1 s: nothing happens.
    h.transport.set_default_output_for_test(None)
    h.scheduler.advance(0.5)
    h.transport.set_default_output_for_test(h.output)
    h.scheduler.advance(2.0)
    assert h.status == "processing"
    assert len(h.transport.events) == events_before
    # Sustained loss tears down and reports unavailable.
    h.transport.set_default_output_for_test(None)
    h.transport.default_output = None
    h.scheduler.advance(1.1)
    assert h.status == "unavailable"
    return h.trace()


def sleep_wake_cycle(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    assert h.status == "processing"
    h.controller.will_sleep()
    assert h.status == "inactive"
    assert h.transport.all_released
    h.controller.did_wake()
    assert h.status == "processing"  # already verified: straight through
    return h.trace()


def cleanup_retry_loop_preserves_and_finishes_teardown(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    h.transport.teardown_failures_remaining["stop_io"] = 2
    h.controller.will_sleep()
    assert not h.transport.all_released  # teardown failed, chain preserved
    h.scheduler.advance(1.0)  # first cleanup retry fails (1 remaining)
    assert not h.transport.all_released
    h.scheduler.advance(1.0)  # second retry succeeds
    assert h.transport.all_released
    return h.trace()


def live_equalizer_fast_path_does_not_restart_pipeline(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    events_before = len(h.transport.events)
    h.controller.update_readiness("equalizerTarget")
    assert len(h.graph.update_calls) == 1
    assert len(h.transport.events) == events_before  # no restart
    assert h.status == "processing"
    return h.trace()


def render_failure_reports_pipeline_issue_and_recovers(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    h.controller.render_failure("io error")
    assert h.status == "recovering"
    assert h.has_issue("PIPELINE")
    h.scheduler.advance(1.0)
    assert h.status in ("starting", "processing")
    return h.trace()


def terminate_stops_everything(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    h.controller.terminate()
    assert h.status == "inactive"
    assert h.transport.all_released
    h.controller.did_wake()  # no resurrection after terminate
    assert h.status == "inactive"
    return h.trace()


def promotion_survives_late_verification_signals(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    assert h.status == "processing"
    promoted = h.controller.pipeline
    h.drive_signal()  # late signal through the (new) io callback
    assert h.controller.pipeline is promoted  # no churn
    assert h.status == "processing"
    return h.trace()


def retry_now_while_processing_does_not_leak_a_pipeline(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    assert h.status == "processing"
    h.controller.retry_now()
    assert len(h.transport.callbacks) == 1  # exactly one live chain
    assert h.controller.pipeline is not None
    return h.trace()


def duplicate_device_loss_notifications_keep_one_grace_timer(P):
    h = Harness(P)
    h.controller.launch()
    h.drive_signal()
    running = h.controller.pipeline
    h.transport.set_default_output_for_test(None)
    h.transport.set_default_output_for_test(None)  # duplicate notification
    h.transport.set_default_output_for_test(h.output)  # restored in time
    h.scheduler.advance(5.0)  # past any grace window
    assert h.controller.pipeline is running  # no spurious restart
    assert h.status == "processing"
    return h.trace()


def failed_verification_teardown_defers_promotion(P):
    h = Harness(P)
    h.controller.launch()
    h.transport.teardown_failures_remaining["stop_io"] = 1
    h.drive_signal()
    assert h.status == "recovering"
    assert h.controller.pipeline is None  # nothing stacked on the live tap
    h.scheduler.advance(1.0)
    assert h.status == "processing"
    assert h.controller.pipeline.purpose.value == "processing"
    assert len(h.transport.callbacks) == 1
    return h.trace()


RUNTIME_CASES = [
    pipeline_acquire_order_and_stop_order,
    pipeline_unwind("create_tap", []),
    pipeline_unwind("create_aggregate", ["destroy_tap"]),
    pipeline_unwind("create_io", ["destroy_aggregate", "destroy_tap"]),
    pipeline_unwind("start_io", ["destroy_io", "destroy_aggregate",
                                 "destroy_tap"]),
    pipeline_rejects_unsupported_output_and_format_mismatch,
    pipeline_failed_teardown_preserves_chain_for_retry,
    pipeline_purpose_driven_callback_behavior,
    transport_protocol_has_no_route_or_volume_mutation,
    launch_verifies_then_promotes_to_processing,
    quiet_signal_does_not_verify,
    verification_timeout_schedules_retry_ladder_then_passthrough,
    stale_preparation_completion_is_dropped,
    permission_denied_never_auto_retries,
    unsupported_output_is_native_passthrough_without_retry,
    pipeline_start_failure_retries_and_stability_resets_ladder,
    device_loss_grace_period,
    sleep_wake_cycle,
    cleanup_retry_loop_preserves_and_finishes_teardown,
    live_equalizer_fast_path_does_not_restart_pipeline,
    render_failure_reports_pipeline_issue_and_recovers,
    terminate_stops_everything,
    promotion_survives_late_verification_signals,
    retry_now_while_processing_does_not_leak_a_pipeline,
    duplicate_device_loss_notifications_keep_one_grace_timer,
    failed_verification_teardown_defers_promotion,
]


@pytest.mark.parametrize("scenario", RUNTIME_CASES,
                         ids=[s.__name__ for s in RUNTIME_CASES])
def test_runtime_matches_jax(scenario):
    trace = run_both(scenario)
    assert trace


# --- probe ------------------------------------------------------------------------


def probe_stimulus_properties(P):
    probe = P.probe.probe_stimulus(48_000.0, seconds=0.25)
    assert probe.shape == (2, 12_000)
    assert float(np.max(np.abs(probe))) <= 0.25 + 1e-6
    assert float(np.max(np.abs(probe))) > 0.2
    assert abs(probe[0, 0]) < 1e-3 and abs(probe[0, -1]) < 1e-3
    assert abs(float(np.mean(probe))) < 1e-3
    np.testing.assert_array_equal(probe, P.probe.probe_stimulus(48_000.0,
                                                                0.25))
    with pytest.raises(ValueError):
        P.probe.probe_stimulus(48_000.0, seconds=0.0)
    return probe.tobytes()


def probe_plays_through_synthetic_transport_capture_path(P):
    out = P.transport.OutputDeviceDescriptor(uid="synth",
                                             nominal_sample_rate=48_000.0)
    transport = P.synthetic.SyntheticTransport(out, amplitude=0.0)
    captured = []
    tap = transport.create_tap(P.transport.StreamTapRequest(
        output=out, purpose=P.transport.TapPurpose.VERIFICATION))
    agg = transport.create_aggregate(tap)
    io = transport.create_io(agg, lambda x: (captured.append(x), x)[1])
    transport.start_io(io)
    probe = P.probe.CaptureProbe(sink=transport, sample_rate=48_000.0)
    transport.pump(512)
    assert np.max(np.abs(captured[-1])) < 1e-6  # silence before the probe
    probe.play()
    transport.pump(512)
    assert np.max(np.abs(captured[-1])) > 0.1  # probe audible in capture
    probe.stop()
    transport.pump(512)
    assert probe.play_count == 1 and transport.frames_pumped == 1536
    return np.concatenate(captured, -1).tobytes()


@pytest.mark.parametrize("scenario", [
    probe_stimulus_properties,
    probe_plays_through_synthetic_transport_capture_path,
], ids=lambda s: s.__name__)
def test_probe_matches_jax(scenario):
    run_both(scenario)


# --- presentation and launch policies ----------------------------------------------


def update_state_model_no_update_error_is_benign(P):
    pres = P.pres
    model = pres.UpdateStateModel()
    phases = []
    model.began_checking()
    assert model.phase == pres.UpdatePhase.CHECKING
    model.finished(error_code=pres.NO_UPDATE_ERROR_CODE)
    assert model.phase == pres.UpdatePhase.CURRENT
    phases.append(model.phase.value)
    model.began_checking()
    model.found("2.1")
    assert model.phase == pres.UpdatePhase.AVAILABLE and model.version == "2.1"
    model.finished(error_code=None)  # success completion keeps the result
    assert model.phase == pres.UpdatePhase.AVAILABLE
    phases.append(model.phase.value)
    model.finished(error_code=42, message="network down")
    assert model.phase == pres.UpdatePhase.ERROR
    assert model.message == "network down"
    assert model.version is None  # no stale version in the error state
    phases.append(model.phase.value)
    model.began_checking()
    model.found_no_update()
    assert model.phase == pres.UpdatePhase.CURRENT
    assert model.message is None and model.version is None
    phases.append(model.phase.value)
    return phases


def launch_routing_policy(P):
    pres = P.pres
    route = pres.route_launch
    R, L = pres.LaunchRoute, pres.LaunchReason
    assert route(L.LOGIN_ITEM, False, False) == R.HEADLESS
    assert route(L.LOGIN_ITEM, True, False) == R.HEADLESS
    assert route(L.USER_OPEN, False, False) == R.SETUP
    assert route(L.USER_OPEN, False, True) == R.SETTINGS  # deferred
    assert route(L.USER_OPEN, True, False) == R.SETTINGS
    return [route(reason, complete, deferred).value for reason in L
            for complete in (False, True) for deferred in (False, True)]


def status_presentation_and_capture_guidance(P):
    pres, st = P.pres, P.state
    state = st.AudioRuntimeState()
    seen = []
    for status in st.Status:
        state.publish(status)
        p = pres.present_status(state)
        seen.append((p.title, p.severity, p.health_lines))
    state.publish(st.Status.PROCESSING)
    p = pres.present_status(state)
    assert p.title == "Processing" and p.severity == "ok"
    state.set_health_issue(
        st.HealthCategory.EQUALIZER,
        st.RuntimeHealthIssue(st.HealthCategory.EQUALIZER,
                              "Equalizer line 3: bad"))
    p = pres.present_status(state)
    assert p.severity == "warning"
    assert p.health_lines == ("Equalizer line 3: bad",)
    seen.append((p.title, p.severity, p.health_lines))
    state.set_capture_access(st.CaptureAccess.DENIED)
    guidance = pres.capture_guidance(state)
    assert "privacy settings" in guidance
    state.publish(st.Status.NEEDS_PERMISSION)
    assert pres.present_status(state).severity == "error"
    return seen, guidance


def launch_intent_classification_matrix(P):
    pres = P.pres
    C, I, E = pres.classify_launch, pres.LaunchIntent, pres.LaunchEvent
    assert C(E("open", sender=pres.LOGIN_WINDOW_SENDER)) == I.LOGIN_ITEM_LAUNCH
    assert C(E("reopen",
               sender=pres.LOGIN_WINDOW_SENDER)) == I.LOGIN_ITEM_LAUNCH
    assert C(E("open", sender="shell.terminal",
               login_item_marker=True)) == I.LOGIN_ITEM_LAUNCH
    assert C(E("open", sender="shell.terminal")) == I.USER_COLD_OPEN
    assert C(E("reopen", sender=None)) == I.USER_REOPEN
    assert C(E("open-documents", login_item_marker=True)) is None
    assert C(E("quit")) is None
    return [getattr(C(E(kind, sender=sender, login_item_marker=marker)),
                    "value", None)
            for kind in ("open", "reopen", "quit")
            for sender in (pres.LOGIN_WINDOW_SENDER, "shell.terminal", None)
            for marker in (False, True)]


def window_action_full_matrix(P):
    pres = P.pres
    A, I, W = pres.window_action, pres.LaunchIntent, pres.WindowAction
    for complete in (False, True):
        for deferred in (False, True):
            assert A(I.LOGIN_ITEM_LAUNCH, complete, deferred) == W.NONE
    for intent in (I.USER_COLD_OPEN, I.USER_REOPEN):
        assert A(intent, False, False) == W.SETUP
        assert A(intent, False, True) == W.SETTINGS   # deferred setup
        assert A(intent, True, False) == W.SETTINGS
        assert A(intent, True, True) == W.SETTINGS
    return [A(intent, complete, deferred).value for intent in I
            for complete in (False, True) for deferred in (False, True)]


def launch_coordinator_dedup_same_delivery_allows_later_events(P):
    pres = P.pres
    coord = pres.LaunchWindowCoordinator()
    I, W = pres.LaunchIntent, pres.WindowAction
    assert coord.action(I.USER_COLD_OPEN, False, delivery_id="d1") == W.SETUP
    assert coord.action(I.USER_COLD_OPEN, False, delivery_id="d1") == W.NONE
    assert coord.action(I.USER_REOPEN, True, delivery_id="d2") == W.SETTINGS
    assert coord.action(I.USER_REOPEN, True, delivery_id="d2") == W.NONE
    assert coord.action(I.USER_REOPEN, False, delivery_id="d3") == W.SETUP
    assert coord.action(I.USER_REOPEN, True, delivery_id="d3") == W.NONE
    return True


def launch_coordinator_queues_until_ready(P):
    pres = P.pres
    coord = pres.LaunchWindowCoordinator()
    I, W = pres.LaunchIntent, pres.WindowAction
    assert coord.action(I.LOGIN_ITEM_LAUNCH, True, ready=False,
                        delivery_id="a") == W.NONE
    assert coord.action(I.USER_REOPEN, True, ready=False,
                        delivery_id="b") == W.NONE
    drained = coord.drain_pending_actions(setup_complete=True)
    assert drained == [
        pres.PendingLaunchAction(I.LOGIN_ITEM_LAUNCH, W.NONE),
        pres.PendingLaunchAction(I.USER_REOPEN, W.SETTINGS),
    ]
    assert coord.drain_pending_actions(setup_complete=True) == []
    coord.action(I.USER_COLD_OPEN, True, ready=False, delivery_id="c")
    late = coord.drain_pending_actions(setup_complete=False)
    assert late == [pres.PendingLaunchAction(I.USER_COLD_OPEN, W.SETUP)]
    return [(a.intent.value, a.action.value) for a in drained + late]


def termination_policy_matrix(P):
    pres = P.pres
    calls = []
    app = pres.ApplicationLifecycle(terminate=lambda: calls.append(1))
    R = pres.TerminationReply
    replies = [app.termination_reply()]
    assert replies[-1] == R.CANCEL and app.terminate_call_count == 0
    app.begin_update_relaunch_termination()
    replies += [app.termination_reply(), app.termination_reply()]
    assert replies[1:] == [R.NOW, R.CANCEL]
    assert app.terminate_call_count == 0
    app.request_explicit_quit()
    assert app.terminate_call_count == 1 and calls == [1]
    replies += [app.termination_reply(), app.termination_reply()]
    assert replies[3:] == [R.NOW, R.CANCEL]
    return [r.value for r in replies]


SHELL_CASES = [
    update_state_model_no_update_error_is_benign,
    launch_routing_policy,
    status_presentation_and_capture_guidance,
    launch_intent_classification_matrix,
    window_action_full_matrix,
    launch_coordinator_dedup_same_delivery_allows_later_events,
    launch_coordinator_queues_until_ready,
    termination_policy_matrix,
]


@pytest.mark.parametrize("scenario", SHELL_CASES,
                         ids=[s.__name__ for s in SHELL_CASES])
def test_presentation_matches_jax(scenario):
    run_both(scenario)


def test_thread_scheduler_fires_and_cancels():
    """ThreadScheduler (the controller's default) fires a timer on its own
    thread and cancels a pending one, in both packages."""
    import threading

    for P in PACKAGES.values():
        sched = P.scheduler.ThreadScheduler()
        fired = threading.Event()
        cancelled = []
        sched.schedule(0.0, fired.set)
        token = sched.schedule(30.0, lambda: cancelled.append(1))
        assert fired.wait(10.0)
        sched.cancel(token)
        sched.cancel_all()
        assert cancelled == []
