"""Race discipline of the PyTorch port: the cases of
tests/test_race_discipline.py against airwave_tpu_torch.

A control thread publishes EQ targets while the render loop processes (the
host processor's output stays finite and inside the gain envelopes); the
live engine takes HRIR swaps and EQ retargets between blocks (generation
semantics, and the retirement handoff drained every block so the third and
later retargets land); the transport error taxonomy and the capture-signal
thresholds. The two BinauralEngine cases also run the JAX engine on the
same blocks, swaps and retargets, and hold the port's output to it at
rel-RMS 1e-5 (the chain contract, TOL of tests/test_torch_hotswap.py)."""

import threading
import time

import numpy as np

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io import apo as japo
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.models.binaural import BinauralEngine as JEngine
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.config import DEFAULT_CONFIG
from airwave_tpu_torch.graph.eq_processor import ParametricEqualizerProcessor
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io.apo import EqualizerDefinition
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.models.binaural import BinauralEngine as TEngine
from airwave_tpu_torch.runtime.controller import _classify
from airwave_tpu_torch.runtime.state import HealthCategory, Status
from airwave_tpu_torch.runtime.transport import (CaptureSignalPolicy,
                                                 ErrorKind, TransportError)

BLOCK = 64
SR = 48_000.0
TOL = 1e-5  # port vs JAX engine, rel-RMS


def rel_rms(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((y - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def renderer_pair(bank: np.ndarray):
    """The JAX renderer and the port's (CPU) of one 14-channel bank."""
    return (jprepare(JWAVData(SR, bank), jcm.STEREO, SR, BLOCK),
            tprepare(TWAVData(SR, bank), tcm.STEREO, SR, BLOCK, device="cpu"))


def engine_pair():
    return (JEngine(batch=2, sample_rate=SR, block_size=BLOCK),
            TEngine(batch=2, sample_rate=SR, block_size=BLOCK, device="cpu"))


def test_concurrent_publication_never_corrupts_render_output():
    """The control thread hammers set_target while the render loop
    processes: the output stays finite and every sample lies between the
    gain envelopes' extremes (unity .. +/-6 dB)."""
    processor = ParametricEqualizerProcessor(48_000)
    stop = threading.Event()
    publish_count = [0]

    def control():
        gains = [6.0, -6.0, 3.0, None]
        i = 0
        while not stop.is_set():
            target = gains[i % len(gains)]
            processor.set_target(
                EqualizerDefinition(preamp_db=target) if target is not None
                else None
            )
            publish_count[0] += 1
            i += 1
            time.sleep(0.0005)

    thread = threading.Thread(target=control)
    thread.start()
    try:
        lo = 10 ** (-6 / 20) - 1e-4
        hi = 10 ** (6 / 20) + 1e-4
        deadline = time.time() + 8.0
        while publish_count[0] < 10 and time.time() < deadline:
            left, right = processor.process(
                np.ones(128, np.float32), np.ones(128, np.float32)
            )
            assert np.all(np.isfinite(left)) and np.all(np.isfinite(right))
            assert np.all(left >= lo) and np.all(left <= hi)
            processor.drain_retired_states()
    finally:
        stop.set()
        thread.join()
    assert publish_count[0] >= 10  # the control thread really contended


def test_engine_survives_hrir_swaps_under_load():
    """HRIR hot-swaps between blocks never give non-finite output and
    restart history cleanly (generation semantics); the port's engine
    renders what the JAX engine renders through the same swaps and
    retargets."""
    rng = np.random.default_rng(0)
    renderers = [
        renderer_pair((rng.standard_normal((14, 60 + 100 * i)) * 0.2)
                      .astype(np.float32))
        for i in range(3)
    ]
    jax_engine, engine = engine_pair()
    ys, refs = [], []
    for i in range(30):
        if i % 7 == 0:
            jr, tr = renderers[(i // 7) % 3]
            jax_engine.set_renderer(jr)
            engine.set_renderer(tr)
        if i % 11 == 0:
            jax_engine.set_equalizer(japo.EqualizerDefinition(
                preamp_db=float(i % 5)))
            engine.set_equalizer(EqualizerDefinition(preamp_db=float(i % 5)))
        x = (rng.standard_normal((2, 2, BLOCK)) * 0.3).astype(np.float32)
        y = engine.process_block(x)
        assert np.all(np.isfinite(y)), i
        ys.append(y)
        refs.append(np.asarray(jax_engine.process_block(x)))
    assert rel_rms(np.concatenate(ys, -1), np.concatenate(refs, -1)) <= TOL


def test_error_classification_taxonomy():
    cases = {
        ErrorKind.PERMISSION_DENIED: (HealthCategory.PERMISSION, False,
                                      Status.NEEDS_PERMISSION),
        ErrorKind.UNSUPPORTED_OUTPUT: (HealthCategory.OUTPUT, False,
                                       Status.NATIVE_PASSTHROUGH),
        ErrorKind.TAP_CREATION_FAILED: (HealthCategory.CAPTURE, True,
                                        Status.RECOVERING),
        ErrorKind.FORMAT_MISMATCH: (HealthCategory.CAPTURE, True,
                                    Status.RECOVERING),
        ErrorKind.AGGREGATE_CREATION_FAILED: (HealthCategory.PIPELINE, True,
                                              Status.RECOVERING),
        ErrorKind.RENDER_FAILURE: (HealthCategory.PIPELINE, True,
                                   Status.RECOVERING),
        ErrorKind.DEVICE_LOST: (HealthCategory.OUTPUT, True,
                                Status.RECOVERING),
    }
    for kind, expected in cases.items():
        assert _classify(TransportError(kind)) == expected, kind


def test_capture_signal_policy_thresholds():
    policy = CaptureSignalPolicy()
    # Exactly at the amplitude threshold counts; just below resets.
    assert not policy.observe(DEFAULT_CONFIG.capture_min_amplitude, 2047)
    assert policy.observe(DEFAULT_CONFIG.capture_min_amplitude, 1)
    policy.reset()
    assert not policy.observe(DEFAULT_CONFIG.capture_min_amplitude, 2047)
    assert not policy.observe(9e-5, 64)  # below threshold resets the run
    assert not policy.observe(DEFAULT_CONFIG.capture_min_amplitude, 2047)
    assert policy.observe(1.0, 1)


def test_engine_eq_retargets_keep_working_past_two_transitions():
    """The live engine drains the EQ retirement handoff every block, or the
    third and every later retarget would wait forever; the port's output
    through the five retargets is the JAX engine's."""
    rng = np.random.default_rng(0)
    jr, tr = renderer_pair((rng.standard_normal((14, 200)) * 0.2)
                           .astype(np.float32))
    jax_engine, engine = engine_pair()
    jax_engine.set_renderer(jr)
    engine.set_renderer(tr)
    blocks_per_ramp = -(-960 // BLOCK) + 3
    ys, refs = [], []
    for i in range(5):
        target = EqualizerDefinition(preamp_db=float(i + 1))
        engine.set_equalizer(target)
        jax_engine.set_equalizer(japo.EqualizerDefinition(
            preamp_db=float(i + 1)))
        for _ in range(blocks_per_ramp):
            x = (rng.standard_normal((2, 2, BLOCK)) * 0.3).astype(
                np.float32)
            ys.append(engine.process_block(x))
            refs.append(np.asarray(jax_engine.process_block(x)))
        rt = engine.eq_runtime
        assert rt.active.definition == target, f"retarget {i} wedged"
        assert rt.pending_target is None and not rt.is_transitioning, i
    assert rel_rms(np.concatenate(ys, -1), np.concatenate(refs, -1)) <= TOL
