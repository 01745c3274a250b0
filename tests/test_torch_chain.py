"""models/binaural and models/bake of the PyTorch port against the JAX
package and the float64 oracles, and a bake carried between the two
packages through interop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.models import bake as jbake
from airwave_tpu.models import binaural as jbin
from airwave_tpu.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu.oracle.upols_oracle import UPOLSOracle
from airwave_tpu.ops import eq_block as jeq
from airwave_tpu.ops import upols as jupols
from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                      FilterType)
from airwave_tpu_torch import interop
from airwave_tpu_torch.models import bake as tbake
from airwave_tpu_torch.models import binaural as tbin
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import eq_block as teq
from airwave_tpu_torch.ops import upols as tupols

PORT_TOL = 1e-6
ORACLE_TOL = 1e-5
T, B, S = 64, 3, 2
PREAMP, COEFFS = tbd.design_cascade(
    EqualizerDefinition(-2.0, (EqualizerFilter(1, None, True, FilterType.PEAKING,
                                               1_000, 6, 0.707),)),
    48_000.0,
)


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


def _hrir(rng, length=300):
    return (rng.standard_normal((S, 2, length)) * 0.3).astype(np.float32)


def _oracle_chain(hrir, x):
    """float64 UPOLS per speaker and ear, summed, then the float64 EQ."""
    n = x.shape[-1]
    xa = np.concatenate([x, np.zeros(x.shape[:-1] + ((-n) % T,), x.dtype)], -1)
    out = []
    for b in range(x.shape[0]):
        dry = np.zeros((2, xa.shape[-1]))
        for s in range(S):
            for e in range(2):
                o = UPOLSOracle(hrir[s, e], T)
                dry[e] += np.concatenate([o.process(xa[b, s, i:i + T])
                                          for i in range(0, xa.shape[-1], T)])
        rl, rr = EqCascadeOracle(COEFFS, PREAMP, 48_000).process(
            dry[0].astype(np.float32), dry[1].astype(np.float32))
        out.append(np.stack([rl, rr])[:, :n])
    return np.stack(out)


@pytest.mark.parametrize("M", [1, 4])
def test_bake_matches_jax_and_oracle(M):
    rng = np.random.default_rng(M)
    hrir = _hrir(rng)
    x = (rng.standard_normal((B, S, 7 * T + 19)) * 0.4).astype(np.float32)
    yt, st = tbake.bake(hrir, x, 48_000.0, COEFFS, PREAMP, block_size=T,
                        blocks_per_step=M, device="cpu")
    yj, _ = jbake.bake(hrir, x, 48_000.0, COEFFS, PREAMP, block_size=T,
                       blocks_per_step=M)
    assert yt.shape == yj.shape == (B, 2, x.shape[-1])
    assert rel_rms(yt, yj) <= PORT_TOL
    assert rel_rms(yt, _oracle_chain(hrir, x)) <= ORACLE_TOL
    assert isinstance(st.conv, tupols.PagedConvState if M > 1 else tupols.ConvState)


def test_bake_without_eq_matches_jax():
    rng = np.random.default_rng(7)
    hrir = _hrir(rng, 100)
    x = (rng.standard_normal((2, S, 4 * T)) * 0.4).astype(np.float32)
    for M in (1, 2):
        yt, _ = tbake.bake(hrir, x, 48_000.0, block_size=T, blocks_per_step=M,
                           device="cpu")
        yj, _ = jbake.bake(hrir, x, 48_000.0, block_size=T, blocks_per_step=M)
        assert rel_rms(yt, yj) <= PORT_TOL


def _jax_state(s):
    """The JAX ChainState from interop's numpy one (same field names)."""
    conv = s.conv
    if isinstance(conv, tupols.PagedConvState):
        conv = jupols.PagedConvState(pages=tuple(map(jnp.asarray, conv.pages)))
    else:
        conv = jupols.ConvState(fdl=jnp.asarray(conv.fdl),
                                write_pos=jnp.asarray(conv.write_pos))
    return jbin.ChainState(conv=conv, eq=jeq.EqState(*map(jnp.asarray, s.eq)))


@pytest.mark.parametrize("M", [1, 4])
def test_bake_continues_across_packages(M):
    """A JAX bake's mid-state, carried through interop and continued by the
    port, equals the whole JAX bake; and the other way round."""
    rng = np.random.default_rng(10 + M)
    hrir = _hrir(rng)
    half = 2 * 4 * T
    x = (rng.standard_normal((B, S, 2 * half)) * 0.4).astype(np.float32)
    kw = dict(block_size=T, blocks_per_step=M)
    whole, _ = jbake.bake(hrir, x, 48_000.0, COEFFS, PREAMP, **kw)

    first, mid_j = jbake.bake(hrir, x[:, :, :half], 48_000.0, COEFFS, PREAMP, **kw)
    mid_t = interop.chain_state_from_numpy(mid_j, device="cpu")
    second, end_t = tbake.bake(hrir, x[:, :, half:], 48_000.0, COEFFS, PREAMP,
                               state=mid_t, **kw, device="cpu")
    assert rel_rms(np.concatenate([first, second], -1), whole) <= PORT_TOL

    first_t, mid_t = tbake.bake(hrir, x[:, :, :half], 48_000.0, COEFFS, PREAMP, **kw,
                                device="cpu")
    mid_np = interop.chain_state_to_numpy(mid_t)
    second_j, _ = jbake.bake(hrir, x[:, :, half:], 48_000.0, COEFFS, PREAMP,
                             state=_jax_state(mid_np), **kw)
    assert rel_rms(np.concatenate([first_t, second_j], -1), whole) <= PORT_TOL


@pytest.mark.parametrize("M", [1, 4])
def test_bake_leaves_passed_state_intact(M):
    """The single-block step writes the delay line in place; bake copies a
    passed-in state first, so the same state seeds two equal continuations."""
    rng = np.random.default_rng(20 + M)
    hrir = _hrir(rng)
    x = (rng.standard_normal((B, S, 4 * M * T)) * 0.4).astype(np.float32)
    kw = dict(block_size=T, blocks_per_step=M)

    def copy_of(state):
        s = interop.chain_state_to_numpy(state)
        conv = (s.conv.pages if M > 1 else (s.conv.fdl, s.conv.write_pos))
        return [np.array(a, copy=True) for a in (*conv, *s.eq)]

    _, mid = tbake.bake(hrir, x[:, :, :2 * M * T], 48_000.0, COEFFS, PREAMP, **kw,
                        device="cpu")
    before = copy_of(mid)
    again = [tbake.bake(hrir, x[:, :, 2 * M * T:], 48_000.0, COEFFS, PREAMP,
                        state=mid, **kw, device="cpu")[0] for _ in range(2)]
    np.testing.assert_array_equal(again[0], again[1])
    for a, b in zip(copy_of(mid), before):
        np.testing.assert_array_equal(a, b)


def test_interop_params_round_trip():
    rng = np.random.default_rng(3)
    pj = jupols.make_conv_params(_hrir(rng), T)
    ej = jeq.make_eq_params(COEFFS, PREAMP, T)
    for port, ref in zip(interop.conv_params_from_numpy(pj, device="cpu"), pj):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for port, ref in zip(interop.eq_params_to_numpy(
            interop.eq_params_from_numpy(ej, device="cpu")), ej):
        np.testing.assert_array_equal(port, np.asarray(ref))
    for port, ref in zip(interop.conv_params_to_numpy(
            interop.conv_params_from_numpy(pj, device="cpu")), pj):
        np.testing.assert_array_equal(port, np.asarray(ref))


def _chain_inputs(rng, M):
    hrir = _hrir(rng, 200)
    pj = jupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M)
    pt = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    ej = jeq.make_eq_params(COEFFS, PREAMP, T)
    et = teq.make_eq_params(COEFFS, PREAMP, T, device="cpu")
    return pj, pt, ej, et


@pytest.mark.parametrize("spatial,crossfading", [(True, False), (True, True),
                                                 (False, True)])
def test_chain_step_matches_jax(spatial, crossfading):
    rng = np.random.default_rng(5)
    pj, pt, ej, et = _chain_inputs(rng, 1)
    uj, ut = jeq.unity_eq_params(T), teq.unity_eq_params(T, device="cpu")
    sj = jbin.ChainState(jupols.make_conv_state(B, S, pj.partition_count, T),
                         jeq.eq_begin_transition(jeq.make_eq_state(B)))
    st = interop.chain_state_from_numpy(sj, device="cpu")
    for _ in range(6):
        x = (rng.standard_normal((B, S, T)) * 0.4).astype(np.float32)
        sj, yj = jbin.chain_step_fn(pj, uj, ej, sj, jnp.asarray(x), 960,
                                    spatial, True, crossfading)
        st, yt = tbin.chain_step_fn(pt, ut, et, st, torch.from_numpy(x), 960,
                                    spatial, True, crossfading)
        assert rel_rms(yt.numpy(), np.asarray(yj)) <= PORT_TOL
    np.testing.assert_array_equal(st.eq.counter.numpy(), np.asarray(sj.eq.counter))


@pytest.mark.parametrize("crossfading", [False, True])
def test_chain_step_multi_matches_jax(crossfading):
    rng = np.random.default_rng(6)
    M = 4
    pj, pt, ej, et = _chain_inputs(rng, M)
    sj = jbin.ChainState(
        jupols.make_conv_state_paged(B, S, pj.partition_count, T, M),
        jeq.make_eq_state(B))
    st = interop.chain_state_from_numpy(sj, device="cpu")
    chain = tbin.BinauralChain(pt, et, et, 960, T, blocks_per_step=M)
    st2 = interop.chain_state_from_numpy(sj, device="cpu")
    for _ in range(5):
        x = (rng.standard_normal((B, S, M, T)) * 0.4).astype(np.float32)
        sj, yj = jbin.chain_step_multi_fn(pj, ej, ej, sj, jnp.asarray(x), 960,
                                          True, crossfading)
        st, yt = tbin.chain_step_multi_fn(pt, et, et, st, torch.from_numpy(x),
                                          960, True, crossfading)
        st2, y2 = chain(st2, torch.from_numpy(x), eq_crossfading=crossfading)
        assert yt.shape == (B, M, 2, T)
        assert rel_rms(yt.numpy(), np.asarray(yj)) <= PORT_TOL
        torch.testing.assert_close(y2, yt, rtol=0, atol=1e-6)
    for a, b in zip(st.conv.pages, sj.conv.pages):
        assert rel_rms(a.numpy(), np.asarray(b)) <= PORT_TOL


def test_binaural_chain_module():
    rng = np.random.default_rng(8)
    _, pt, _, et = _chain_inputs(rng, 1)
    chain = tbin.BinauralChain(pt, et, et, 960, T)
    buffers = dict(chain.named_buffers(remove_duplicate=False))
    assert {"conv_Gflip2", "conv_wf", "conv_wi", "eq_to_Hm", "eq_from_G",
            "bank", "synth"} <= set(buffers)
    assert chain.to("cpu") is chain
    for a, b in zip(chain.conv_params, pt):
        assert a is b or torch.equal(a, b)
    st = tbin.ChainState(tupols.make_conv_state(B, S, pt.partition_count, T,
                                                device="cpu"),
                         teq.make_eq_state(B, device="cpu"))
    sr = tbin.ChainState(tupols.make_conv_state(B, S, pt.partition_count, T,
                                                device="cpu"),
                         teq.make_eq_state(B, device="cpu"))
    for _ in range(3):
        x = torch.from_numpy((rng.standard_normal((B, S, T)) * 0.4).astype(np.float32))
        st, y = chain(st, x)
        sr, yr = tbin.chain_step_fn(pt, et, et, sr, x, 960, True, True, False)
        torch.testing.assert_close(y, yr, rtol=0, atol=1e-6)
    assert st.conv.write_pos == 3 % pt.partition_count
