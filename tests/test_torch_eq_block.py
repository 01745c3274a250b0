"""ops/eq_block of the PyTorch port against the JAX package: the steady and
the crossfading eq_step, eq_apply_folded and eq_folded_paged_round, the
serving pool's lane ops, and the float64 cascade oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu.ops import eq_block as jeq
from airwave_tpu.ops import upols as jupols
from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                      FilterType)
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import eq_block as teq
from airwave_tpu_torch.ops import upols as tupols

PORT_TOL = 1e-6
ORACLE_TOL = 1e-5
# The production block. At T = 64 this high-Q cascade's fp32 block form is
# itself ~3e-6 from float64 (JAX and port alike), so port-vs-JAX agreement
# at 1e-6 is only meaningful at the block size the chain runs.
T = 512

DEFINITION = EqualizerDefinition(
    preamp_db=-2.56,
    filters=(
        EqualizerFilter(1, None, True, FilterType.LOW_SHELF, 105.0, -2.8, 0.70),
        EqualizerFilter(2, None, True, FilterType.PEAKING, 894.2, 2.0, 1.24),
        EqualizerFilter(3, None, True, FilterType.PEAKING, 6165.4, 2.3, 5.37),
        EqualizerFilter(4, None, True, FilterType.HIGH_SHELF, 10_000.0, -5.2, 0.70),
    ),
)


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


def _params(T, definition=DEFINITION):
    pre, co = tbd.design_cascade(definition, 48_000.0)
    return (teq.make_eq_params(co, pre, T, device="cpu"),
            jeq.make_eq_params(co, pre, T), (pre, co))


def _to_torch_state(sj):
    return teq.EqState(*(torch.tensor(np.asarray(a)) for a in sj))


def test_eq_step_steady_matches_jax_and_oracle():
    rng = np.random.default_rng(3)
    B, n = 2, 12
    pt, pj, (pre, co) = _params(T)
    x = (rng.standard_normal((B, 2, n * T)) * 0.5).astype(np.float32)
    st, sj = teq.make_eq_state(B, device="cpu"), jeq.make_eq_state(B)
    outs_t, outs_j = [], []
    for i in range(n):
        blk = x[:, :, i * T:(i + 1) * T]
        st, yt = teq.eq_step(pt, pt, st, torch.from_numpy(blk), 960, False)
        sj, yj = jeq.eq_step(pj, pj, sj, jnp.asarray(blk), 960, False)
        outs_t.append(yt.numpy())
        outs_j.append(np.asarray(yj))
    got, ref = np.concatenate(outs_t, -1), np.concatenate(outs_j, -1)
    assert rel_rms(got, ref) <= PORT_TOL
    assert rel_rms(st.s_to.numpy(), np.asarray(sj.s_to)) <= PORT_TOL
    np.testing.assert_array_equal(st.counter.numpy(), np.asarray(sj.counter))
    for b in range(B):
        rl, rr = EqCascadeOracle(co, pre, 48_000).process(x[b, 0], x[b, 1])
        assert rel_rms(got[b], np.stack([rl, rr])) <= ORACLE_TOL


def test_eq_step_crossfade_matches_jax():
    """unity -> target over a 960-sample ramp, one lane mid-transition and
    one idle; the counters saturate at COUNTER_IDLE."""
    rng = np.random.default_rng(4)
    B = 2
    pt, pj, _ = _params(T)
    ut, uj = teq.unity_eq_params(T, device="cpu"), jeq.unity_eq_params(T)
    sj = jeq.eq_begin_transition(jeq.make_eq_state(B),
                                 jnp.asarray([True, False]))
    st = _to_torch_state(sj)
    for i in range(3):  # 1536 samples: past the 960-sample ramp
        blk = (rng.standard_normal((B, 2, T)) * 0.5).astype(np.float32)
        st, yt = teq.eq_step(ut, pt, st, torch.from_numpy(blk), 960)
        sj, yj = jeq.eq_step(uj, pj, sj, jnp.asarray(blk), 960)
        assert rel_rms(yt.numpy(), np.asarray(yj)) <= PORT_TOL, i
        np.testing.assert_array_equal(st.counter.numpy(), np.asarray(sj.counter))
    # The unity cascade has no state: s_from stays zero on both sides.
    np.testing.assert_array_equal(st.s_from.numpy(), np.asarray(sj.s_from))
    assert rel_rms(st.s_to.numpy(), np.asarray(sj.s_to)) <= PORT_TOL
    assert st.counter.dtype == torch.int32
    assert int(st.counter[1]) == teq.COUNTER_IDLE


def test_eq_apply_folded_matches_jax():
    rng = np.random.default_rng(5)
    B, M, N = 3, 4, 128
    pt, pj, _ = _params(T)
    fir = rng.standard_normal((B, M, 2, T)).astype(np.float32)
    drive = (rng.standard_normal((B, M, 2, N)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, 2, N)) * 0.1).astype(np.float32)
    sj = jeq.EqState(jnp.zeros_like(s0), jnp.asarray(s0),
                     jnp.asarray(np.array([0, 100, int(jeq.COUNTER_IDLE)], np.int32)))
    sj2, yj = jeq.eq_apply_folded(pj, sj, jnp.asarray(fir), jnp.asarray(drive))
    st2, yt = teq.eq_apply_folded(pt, _to_torch_state(sj), torch.from_numpy(fir),
                                  torch.from_numpy(drive))
    assert rel_rms(yt.numpy(), np.asarray(yj)) <= PORT_TOL
    assert rel_rms(st2.s_to.numpy(), np.asarray(sj2.s_to)) <= PORT_TOL
    np.testing.assert_array_equal(st2.counter.numpy(), np.asarray(sj2.counter))


@pytest.mark.parametrize("M", [2, 4])
def test_eq_folded_paged_round_matches_jax(M):
    rng = np.random.default_rng(M)
    B, S = 2, 2
    pt, pj, _ = _params(T)
    hrir = (rng.standard_normal((S, 2, 1200)) * 0.3).astype(np.float32)
    cj = jupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M)
    ct = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    csj = jupols.make_conv_state_paged(B, S, cj.partition_count, T, M)
    cst = tupols.make_conv_state_paged(B, S, ct.partition_count, T, M, device="cpu")
    esj, est = jeq.make_eq_state(B), teq.make_eq_state(B, device="cpu")
    for _ in range(2 * len(cst.pages) + 1):
        x = (rng.standard_normal((B, S, M, T)) * 0.4).astype(np.float32)
        csj, esj, yj = jeq.eq_folded_paged_round(cj, pj, csj, esj, jnp.asarray(x))
        cst, est, yt = teq.eq_folded_paged_round(ct, pt, cst, est,
                                                 torch.from_numpy(x))
        assert yt.shape == (B, M, 2, T)
        assert rel_rms(yt.numpy(), np.asarray(yj)) <= PORT_TOL
    assert rel_rms(est.s_to.numpy(), np.asarray(esj.s_to)) <= PORT_TOL
    np.testing.assert_array_equal(est.counter.numpy(), np.asarray(esj.counter))


@pytest.mark.parametrize("op", ["eq_begin_transition", "eq_finish_transition",
                                "eq_reset"])
@pytest.mark.parametrize("masked", [False, True])
def test_lane_ops_match_jax(op, masked):
    """The pool's EQ lane ops, on all lanes or a [B] mask: equal to the
    JAX ops, with the int32 counter kept int32."""
    rng = np.random.default_rng(12)
    B, N = 5, 16
    s_from = rng.standard_normal((B, 2, N)).astype(np.float32)
    s_to = rng.standard_normal((B, 2, N)).astype(np.float32)
    counter = np.array([0, 77, 960, teq.COUNTER_IDLE, 5], np.int32)
    mask = np.array([True, False, True, True, False]) if masked else None
    sj = getattr(jeq, op)(
        jeq.EqState(jnp.asarray(s_from), jnp.asarray(s_to),
                    jnp.asarray(counter)),
        None if mask is None else jnp.asarray(mask))
    st = getattr(teq, op)(
        teq.EqState(torch.from_numpy(s_from), torch.from_numpy(s_to),
                    torch.from_numpy(counter)),
        None if mask is None else torch.from_numpy(mask))
    assert st.counter.dtype == torch.int32
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
