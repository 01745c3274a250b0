"""runtime/feeder.DeviceFeeder of the port against the JAX package's.

The case of tests/test_probe_and_feeder.py:50 runs on both feeders over
the same seeded blocks (the port's on device="cpu", where a block is
copied into a tensor and no stream is used), and the feeders' protocol
errors and flush are held equal. The card path (pinned buffers, the copy
stream, bit-equality with the unstaged loop) is tests/test_torch_cuda.py
and chip_smoke.py's feeder phase."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.models import binaural as jbin
from airwave_tpu.ops import eq_block as jeq
from airwave_tpu.ops import upols as jupols
from airwave_tpu.runtime.feeder import DeviceFeeder as JFeeder
from airwave_tpu_torch.models import binaural as tbin
from airwave_tpu_torch.ops import eq_block as teq
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.runtime.feeder import DeviceFeeder as TFeeder

T, B, S = 64, 2, 2
PORT_TOL = 1e-6  # rel-RMS, the port against the JAX package (f32 sums)


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


def _steps(hrir):
    """(JAX step, fresh JAX state, port step, fresh port state) of the
    single-block chain, EQ off, as tests/test_probe_and_feeder.py:50."""
    jparams = jupols.make_conv_params(hrir, T)
    jeqp = jeq.unity_eq_params(T)
    jstep = jax.jit(functools.partial(
        jbin.chain_step_fn, jparams, jeqp, jeqp, transition_length=960,
        spatial_enabled=True, eq_enabled=False))

    def jstate():
        return jbin.ChainState(
            conv=jupols.make_conv_state(B, S, jparams.partition_count, T),
            eq=jeq.make_eq_state(B))

    tparams = tupols.make_conv_params(hrir, T, device="cpu")
    teqp = teq.unity_eq_params(T, device="cpu")
    tstep = functools.partial(
        tbin.chain_step_fn, tparams, teqp, teqp, transition_length=960,
        spatial_enabled=True, eq_enabled=False)

    def tstate():
        return tbin.ChainState(
            conv=tupols.make_conv_state(B, S, tparams.partition_count, T,
                                        device="cpu"),
            eq=teq.make_eq_state(B, device="cpu"))

    return jstep, jstate, tstep, tstate


def _fed(feeder, blocks, fetch):
    feeder.prime(blocks[0])
    got = [fetch(feeder.step(b)) for b in blocks[1:]]
    got.append(fetch(feeder.flush()))
    return np.concatenate(got, -1)


@pytest.mark.parametrize("seed", [0, 1])
def test_feeder_matches_jax_feeder_and_unstaged_loop(seed):
    """Each feeder equals its own package's unstaged loop (the JAX one
    within the JAX test's atol 1e-6, the port's bit for bit), both take 5
    steps, and the two feeders' outputs agree within the cross-package
    rel-RMS 1e-6 (the outputs reach |y| ~ 13, where f32 sums in another
    order differ by a few 1e-6 absolute)."""
    rng = np.random.default_rng(seed)
    hrir = (rng.standard_normal((S, 2, 128)) * 0.3).astype(np.float32)
    blocks = [rng.standard_normal((B, S, T)).astype(np.float32)
              for _ in range(5)]
    jstep, jstate, tstep, tstate = _steps(hrir)

    jf = JFeeder(jstep, jstate())
    want = _fed(jf, blocks, np.asarray)
    tf = TFeeder(tstep, tstate(), device="cpu")
    got = _fed(tf, blocks, lambda y: y.numpy())
    assert jf.steps == tf.steps == 5
    assert rel_rms(got, want) <= PORT_TOL

    jplain, state = [], jstate()
    for b in blocks:
        state, y = jstep(state, jnp.asarray(b))
        jplain.append(np.asarray(y))
    np.testing.assert_allclose(want, np.concatenate(jplain, -1), atol=1e-6)
    state, plain = tstate(), []
    for b in blocks:
        state, y = tstep(state, torch.from_numpy(b))
        plain.append(y.numpy())
    np.testing.assert_array_equal(got, np.concatenate(plain, -1))
    assert tf.pinned_bytes == 0  # the CPU path stages nothing


def test_feeder_copies_the_block_it_stages():
    """The staged block is a copy, as jax.device_put makes one: the caller
    may reuse its buffer as soon as prime/step return."""
    seen = []
    feeder = TFeeder(lambda s, x: (s, seen.append(x.clone()) or x), None,
                     device="cpu")
    buf = np.ones((2, 3), np.float32)
    feeder.prime(buf)
    buf[:] = 7.0
    feeder.step(buf)
    buf[:] = 9.0
    feeder.flush()
    assert [float(x[0, 0]) for x in seen] == [1.0, 7.0]


@pytest.mark.parametrize("misuse", ["prime_twice", "step_before_prime"])
def test_feeder_protocol_errors_match_jax(misuse):
    """prime twice and step before prime fail as in the JAX package."""
    errors = {}
    for name, cls, kw in (("jax", JFeeder, {}),
                          ("port", TFeeder, {"device": "cpu"})):
        feeder = cls(lambda s, x: (s, x), None, **kw)
        with pytest.raises(AssertionError) as err:
            if misuse == "prime_twice":
                feeder.prime(np.zeros(2, np.float32))
                feeder.prime(np.zeros(2, np.float32))
            else:
                feeder.step(np.zeros(2, np.float32))
        errors[name] = str(err.value)
        assert feeder.steps == 0
    assert errors["jax"] == errors["port"]


def test_flush_with_nothing_staged_returns_none():
    for feeder in (JFeeder(lambda s, x: (s, x), None),
                   TFeeder(lambda s, x: (s, x), None, device="cpu")):
        assert feeder.flush() is None
        feeder.prime(np.zeros(2, np.float32))
        assert feeder.flush() is not None
        assert feeder.flush() is None
        assert feeder.steps == 1


def test_feeder_defaults_to_the_card():
    """The default device is cuda:0; without a card it raises."""
    if torch.cuda.is_available():
        assert TFeeder(lambda s, x: (s, x), None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            TFeeder(lambda s, x: (s, x), None)
