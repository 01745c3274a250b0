"""The host EQ processor protocol of the PyTorch port: the cases of
tests/test_eq_processor.py against airwave_tpu_torch/graph/eq_processor.py
and graph/eq_runtime.py (the exact 20 ms ramp across callback boundaries,
ramps to and from unity, newest-wins queueing, retirement backpressure, the
contended publication lock, reset, preparation errors, canaries, and the
device runtime's snapshot of a definition-less target), with the same
assertions; and the JAX processor and the port's fed one publication
schedule (retargets, retirement pressure, a reset, a contended lock) agree
within 1e-6 absolute, sample by sample."""

import numpy as np
import pytest

from airwave_tpu.graph.eq_processor import ParametricEqualizerProcessor as JProc
from airwave_tpu.io import apo as japo
from airwave_tpu_torch.graph.eq_processor import ParametricEqualizerProcessor
from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                      FilterType)
from airwave_tpu_torch.utils import errors

PARITY_ATOL = 1e-6


def run(processor, frames, left_value=1.0, right_value=1.0):
    left = np.full(frames, left_value, np.float32)
    right = np.full(frames, right_value, np.float32)
    return processor.process(left, right)


def preamp_def(db):
    return EqualizerDefinition(preamp_db=db)


def test_unity_and_preamp_only_states_no_crosstalk():
    p = ParametricEqualizerProcessor(48_000)
    in_l = np.array([0.25, -0.5, 1], np.float32)
    in_r = np.array([-0.75, 0.5, 0.125], np.float32)
    out_l, out_r = p.process(in_l, in_r)
    np.testing.assert_array_equal(out_l, in_l)
    np.testing.assert_array_equal(out_r, in_r)

    p2 = ParametricEqualizerProcessor(48_000)
    p2.set_target(preamp_def(6.0))
    run(p2, 960)  # the ramp completes; then pure gain
    gain = 10 ** (6 / 20)
    out_l, out_r = p2.process(in_l, in_r)
    np.testing.assert_allclose(out_l, in_l * gain, atol=1e-6)
    np.testing.assert_allclose(out_r, in_r * gain, atol=1e-6)


@pytest.mark.parametrize("sample_rate", [44_100.0, 48_000.0, 96_000.0])
def test_crossfade_exact_ramp_across_callback_boundaries(sample_rate):
    p = ParametricEqualizerProcessor(sample_rate)
    gain = np.float32(10 ** (6 / 20))
    p.set_target(preamp_def(6.0))
    length = max(1, round(sample_rate * 0.020))
    first_half = max(1, length // 2)

    first_l, _ = run(p, first_half)
    second_l, second_r = run(p, length - first_half)
    assert abs(first_l[0] - (1 + (gain - 1) / length)) < 1e-5
    assert abs(second_l[-1] - gain) < 1e-5
    assert abs(second_r[-1] - gain) < 1e-5
    assert np.all(np.isfinite(np.concatenate([first_l, second_l])))


def test_transitions_to_and_from_unity_use_same_ramp():
    p = ParametricEqualizerProcessor(48_000)
    p.set_target(preamp_def(6.0))
    length = 960
    run(p, length)
    p.set_target(None)
    out_l, out_r = run(p, length)
    gain = 10 ** (6 / 20)
    assert abs(out_l[0] - (gain - (gain - 1) / length)) < 1e-5
    assert abs(out_l[-1] - 1) < 1e-5
    assert abs(out_r[-1] - 1) < 1e-5


def test_rapid_publication_queues_newest_target():
    p = ParametricEqualizerProcessor(48_000)
    positive = 10 ** (6 / 20)
    negative = 10 ** (-6 / 20)
    length = 960

    p.set_target(preamp_def(6.0))
    run(p, length // 2)
    p.set_target(preamp_def(-6.0))
    completes_first, _ = run(p, length // 2)
    assert abs(completes_first[-1] - positive) < 1e-5

    starts_newest, starts_r = run(p, length)
    assert abs(starts_newest[-1] - negative) < 1e-5
    assert np.all(np.isfinite(starts_newest))
    assert np.all(np.isfinite(starts_r))


def test_retirement_pressure_defers_until_control_drain():
    p = ParametricEqualizerProcessor(48_000)
    length = 960
    first_gain = 10 ** (6 / 20)
    second_gain = 10 ** (-6 / 20)
    newest_gain = 10 ** (12 / 20)

    p.set_target(preamp_def(6.0))
    run(p, length)

    p.set_target(preamp_def(-6.0))
    second, _ = run(p, length)
    assert abs(second[-1] - second_gain) < 1e-5

    p.set_target(preamp_def(12.0))
    held, _ = run(p, length)
    assert abs(held[-1] - second_gain) < 1e-5  # deferred

    p.drain_retired_states()
    newest, _ = run(p, length)
    assert abs(newest[-1] - newest_gain) < 1e-5
    assert abs(second[0] - (first_gain + (second_gain - first_gain) / length)) < 1e-5


def test_contended_publication_lock_keeps_prior_target():
    p = ParametricEqualizerProcessor(48_000)
    p.hold_publication_lock_for_testing(True)
    p.set_target(preamp_def(6.0))
    out_l, out_r = run(p, 128, left_value=1, right_value=2)
    p.hold_publication_lock_for_testing(False)
    np.testing.assert_array_equal(out_l, np.ones(128, np.float32))
    np.testing.assert_array_equal(out_r, np.full(128, 2, np.float32))


def test_reset_clears_published_state_histories():
    p = ParametricEqualizerProcessor(48_000)
    filt = EqualizerFilter(1, None, True, FilterType.PEAKING, 1_000, 6, 0.707)
    p.set_target(EqualizerDefinition(filters=(filt,)))
    run(p, 960)
    p.reset()
    p.set_target(None)
    run(p, 960)
    out_l, out_r = run(p, 1, left_value=0, right_value=0)
    np.testing.assert_array_equal(out_l, [0])
    np.testing.assert_array_equal(out_r, [0])


def test_preparation_rejects_invalid_inputs():
    with pytest.raises(errors.EqualizerPreparationError):
        ParametricEqualizerProcessor(0)
    p = ParametricEqualizerProcessor(48_000)
    bad = EqualizerDefinition(
        filters=(EqualizerFilter(1, None, True, FilterType.PEAKING, 24_000, 1, 1),)
    )
    with pytest.raises(errors.EqualizerPreparationError):
        p.set_target(bad)


def test_canaries_and_finiteness_at_max_callback():
    p = ParametricEqualizerProcessor(48_000)
    filt = EqualizerFilter(1, None, True, FilterType.HIGH_SHELF, 6_000, -5, 0.8)
    p.set_target(EqualizerDefinition(filters=(filt,)))
    size = 4096
    left = np.array([(i % 17) / 17 for i in range(size)], np.float32)
    right = np.array([-(i % 13) / 13 for i in range(size)], np.float32)
    out_l, out_r = p.process(left, right)
    assert out_l.shape == (size,) and out_r.shape == (size,)
    assert np.all(np.isfinite(out_l)) and np.all(np.isfinite(out_r))


def test_eq_runtime_snapshot_restores_definition_less_custom_target():
    """A custom cascade published directly (definition=None, params built
    from a hand-made design) survives snapshot/restore: it never comes back
    as unity."""
    from airwave_tpu_torch.graph.eq_runtime import EqualizerRuntime, PreparedEq
    from airwave_tpu_torch.ops import biquad_design as bd
    from airwave_tpu_torch.ops import eq_block

    rt = EqualizerRuntime(48_000.0, block_size=64, device="cpu")
    coeffs = [bd.make_biquad(FilterType.PEAKING, 4.0, 1000.0, 1.2, 48_000.0)]
    preamp = 0.5
    params = eq_block.make_eq_params(coeffs, preamp, rt.block_size,
                                     rt.state_dim, device="cpu")
    custom = PreparedEq(params, None, 48_000.0, (preamp, coeffs))
    rt.publish(custom)
    state = eq_block.make_eq_state(1, device="cpu")
    state, _, _, _ = rt.begin_block(state)
    rt.after_block(rt.transition_length)  # finish the activation ramp
    state, _, _, _ = rt.begin_block(state)
    assert rt.active is custom

    snap = rt.snapshot()
    rt2 = EqualizerRuntime(48_000.0, block_size=64, device="cpu")
    rt2.restore(snap)
    assert rt2.active.definition is None
    assert rt2.active.design == custom.design
    for got, want in zip(rt2.active.params, custom.params):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _filters(apo, gain: float):
    kinds = (apo.FilterType.PEAKING, apo.FilterType.LOW_SHELF,
             apo.FilterType.HIGH_SHELF)
    return tuple(apo.EqualizerFilter(i + 1, None, True, kinds[i % 3],
                                     200.0 * (i + 1), gain * (-1) ** i, 0.8)
                 for i in range(3))


# The schedule both processors are fed: ("set", preamp dB, the three
# filters' gain in dB or None for none), ("none",) for unity, ("drain",),
# ("reset",), ("lock", held), and ("run", frames) of the seeded input.
SCHEDULE = (
    [("set", 6.0, None), ("run", 300), ("set", -4.0, 3.0), ("run", 200),
     ("run", 700)]  # a retarget mid-ramp: newest wins
    + [("set", 2.0, -5.0), ("run", 960), ("set", 9.0, 1.0), ("run", 960)]
    # retirement pressure: the last target waits for the drain
    + [("drain",), ("run", 1024), ("reset",), ("none",), ("run", 511)]
    + [("lock", True), ("set", -9.0, 4.0), ("run", 257), ("lock", False),
       ("run", 1500), ("drain",), ("run", 4096)]
)


def _feed(processor, apo, rng):
    outs = []
    for step in SCHEDULE:
        kind = step[0]
        if kind == "set":
            _, preamp, gain = step
            filters = () if gain is None else _filters(apo, gain)
            processor.set_target(apo.EqualizerDefinition(preamp, filters))
        elif kind == "none":
            processor.set_target(None)
        elif kind == "drain":
            processor.drain_retired_states()
        elif kind == "reset":
            processor.reset()
        elif kind == "lock":
            processor.hold_publication_lock_for_testing(step[1])
        else:
            x = (rng.standard_normal((2, step[1])) * 0.5).astype(np.float32)
            outs.append(np.stack(processor.process(x[0], x[1])))
    return np.concatenate(outs, axis=-1)


def test_port_processor_matches_jax_on_a_publication_schedule():
    from airwave_tpu_torch.io import apo as tapo

    want = _feed(JProc(48_000), japo, np.random.default_rng(7))
    got = _feed(ParametricEqualizerProcessor(48_000), tapo,
                np.random.default_rng(7))
    assert got.shape == want.shape == (2, sum(s[1] for s in SCHEDULE
                                              if s[0] == "run"))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY_ATOL)
    assert np.abs(got).max() > 0.1  # not silence
