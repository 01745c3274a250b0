"""Checkpointing in the PyTorch port: EqualizerRuntime.snapshot/restore,
StreamPool.snapshot/restore (bit-identical resume on both tiers), resize
into another lane count (tests/test_resize.py:48, 100, 118), and snapshots
moving between the JAX pool and the port's through interop. The port runs
on the CPU (its kernels' plain versions)."""

import numpy as np
import pytest
import torch

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph.eq_runtime import EqualizerRuntime as JRuntime
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io import apo as japo
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.ops import biquad_design as jbd
from airwave_tpu.ops import eq_block as jeq
from airwave_tpu.ops import upols as jupols
from airwave_tpu.runtime import stream_pool as jsp
from airwave_tpu_torch import interop
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.eq_runtime import EqualizerRuntime, PreparedEq
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import eq_block
from airwave_tpu_torch.runtime.stream_pool import StreamPool
from airwave_tpu_torch.utils.errors import EqInvalidFilter

SR = 48_000.0
BLOCK = 64
TOL = 1e-5   # port vs JAX pool, per stream (the chain contract)


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def preset(gain: float, fc: float = 700.0) -> bytes:
    return (f"Preamp: -1.0 dB\nFilter 1: ON PK Fc {fc} Hz Gain {gain} dB Q 1.0\n"
            f"Filter 2: ON HSC Fc 4000 Hz Gain -2 dB Q 0.7\n").encode()


def audio(seed=5, frames=500):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)


def renderer(M=1, seed=5):
    return tprepare(TWAVData(SR, audio(seed)), tcm.STEREO, SR, BLOCK,
                    lookahead=M, device="cpu")


def pool(lanes, M=1, eq=None, **kw):
    return StreamPool(lanes, SR, renderer(M),
                      eq_definition=None if eq is None else tapo.parse(eq, "e"),
                      block_size=BLOCK, blocks_per_step=M, device="cpu",
                      ring_blocks=64, **kw)


def feed(p, lanes, sigs, rounds, skip=()):
    """One step per round to each lane not in `skip` {(lane, round)}."""
    L = p.step_frames
    for i in rounds:
        for s in lanes:
            if (s, i) not in skip:
                p.push(s, sigs[s][:, i * L:(i + 1) * L])
        p.pump()


def signals(lanes, rounds, L, seed=7):
    rng = np.random.default_rng(seed)
    return {s: (rng.standard_normal((2, rounds * L)) * 0.3).astype(np.float32)
            for s in lanes}


# --- EqualizerRuntime ----------------------------------------------------------


def test_eq_runtime_round_trip_mid_ramp():
    """A snapshot mid-ramp with a queued target restores the same machine:
    the same cascades (params bit for bit), ramp clock and queue, and a
    definition-less custom cascade comes back from its packed design."""
    a = EqualizerRuntime(SR, BLOCK, device="cpu")
    eq = eq_block.make_eq_state(2, device="cpu")
    a.set_target(tapo.parse(preset(3.0), "a"))
    eq, *_ = a.begin_block(eq)
    a.after_block(BLOCK)
    a.set_target(tapo.parse(preset(-2.0), "b"))
    eq, *_ = a.begin_block(eq)        # newest wins: queued behind the ramp
    preamp, coeffs = tbd.design_cascade(tapo.parse(preset(5.0, 300.0), "c"), SR)
    custom = PreparedEq(eq_block.make_eq_params(coeffs, preamp, BLOCK,
                                                device="cpu"),
                        None, SR, (preamp, coeffs))
    a.active, a.transition_from = custom, a.active
    snap = a.snapshot()
    assert snap["samples_into_transition"] == BLOCK
    b = EqualizerRuntime(SR, BLOCK, device="cpu")
    b.restore(snap)
    for pa, pb in ((a.active, b.active), (a.transition_from, b.transition_from),
                   (a.pending_target, b.pending_target)):
        assert pa.definition == pb.definition
        for x, y in zip(pa.params, pb.params):
            assert torch.equal(x, y)
    assert b._samples_into_transition == BLOCK and b.observed_target is None
    bare = PreparedEq(custom.params, None, SR)
    a.active = bare
    with pytest.raises(ValueError, match="definition-less"):
        a.snapshot()


def test_eq_runtime_snapshot_moves_between_packages():
    """A JAX runtime's snapshot restores into the port's through interop
    (the definition and design types are converted), and the port's back
    into JAX: the rebuilt cascades agree with the other side's."""
    j = JRuntime(SR, BLOCK)
    j.set_target(japo.parse(preset(3.0), "a"))
    j.begin_block(jeq.make_eq_state(1, 2, 128))
    j.after_block(3 * BLOCK)
    t = EqualizerRuntime(SR, BLOCK, device="cpu")
    t.restore(interop.eq_runtime_snapshot_convert(j.snapshot()))
    assert t.active.definition == tapo.parse(preset(3.0), "a")
    assert t.transition_from is t.unity and t._samples_into_transition == 3 * BLOCK
    for x, y in zip(t.active.params, j.active.params):
        assert rel_rms(x.numpy(), np.asarray(y)) <= 1e-6
    back = JRuntime(SR, BLOCK)
    back.restore(interop.eq_runtime_snapshot_convert(t.snapshot(), japo, jbd))
    assert back.active.definition == j.active.definition
    assert back.transition_from is back.unity


# --- StreamPool.snapshot / restore -----------------------------------------------


@pytest.mark.parametrize("M", [1, 2])
def test_restore_resumes_bit_identical_mid_ramp_with_debt(M):
    """A snapshot mid EQ ramp, with a paused lane owing alignment debt,
    restored into a fresh pool: every later output equals the
    uninterrupted pool's bit for bit. A device copy (materialize=False)
    restores the same, and is not aliased to the carry."""
    a = pool(4, M, eq=preset(2.0))
    lanes = [a.attach() for _ in range(3)]
    L = a.step_frames
    sigs = signals(lanes, 12, L)
    feed(a, lanes, sigs, range(3))
    a.set_equalizer(tapo.parse(preset(-3.0), "b"))
    feed(a, lanes, sigs, range(3, 6), skip={(lanes[2], 4), (lanes[2], 5)})
    for s in lanes:
        a.pull(s, a.available(s))
    snap, dev = a.snapshot(), a.snapshot(materialize=False)
    assert snap["debt"][lanes[2]] > 0
    assert snap["eq_runtime"]["transition_from"] is not None
    assert isinstance(dev["state"].eq.s_to, torch.Tensor)
    b, c = pool(4, M, eq=preset(2.0)), pool(4, M, eq=preset(2.0))
    assert b.restore(snap) is None
    c.restore(dev)
    for p in (a, b, c):
        feed(p, lanes, sigs, range(6, 12))
    want = [a.pull(s, a.available(s)) for s in lanes]
    for p in (b, c):
        for s, w in zip(lanes, want):
            np.testing.assert_array_equal(p.pull(s, w.shape[1]), w)
    # The device copy was not written by a's later rounds.
    c2 = pool(4, M, eq=preset(2.0))
    c2.restore(dev)
    np.testing.assert_array_equal(interop.pool_state_to_numpy(c2._state).eq.s_to,
                                  snap["state"].eq.s_to)
    assert b.attach() not in lanes


def test_restore_clears_fades_and_resets_rings():
    """A fade in flight is not checkpointed: pending lanes jump to the
    active bank. Undelivered audio is dropped."""
    a = pool(2)
    s = a.attach()
    a.push(s, np.ones((2, BLOCK), np.float32))
    a.pump()
    assert a.set_renderer(renderer(seed=9)) is True
    snap = a.snapshot()
    a.push(s, np.ones((2, 3 * BLOCK), np.float32))
    a.restore(snap)
    st = a.stats()
    assert st["hotswap_fading"] == 0 and a._xfade_params is None
    assert a.available(s) == 0 and a.assembler.pending(s) == 0


@pytest.mark.parametrize("new_size", [12, 4])
def test_resize_preserves_lane_history(new_size):
    """tests/test_resize.py:48 on the port: grow and shrink. Attached lanes
    (one with debt) compact to the head in ascending old-id order and
    continue bit for bit as in the uninterrupted pool; a fresh attach on
    the resized pool lands on a clean lane."""
    a = pool(6)
    lanes = [a.attach() for _ in range(3)]
    a.detach(lanes[1])
    lanes = [lanes[0], lanes[2], a.attach()]
    sigs = signals(lanes, 8, BLOCK)
    feed(a, lanes, sigs, range(4), skip={(lanes[2], 2), (lanes[2], 3)})
    for s in lanes:
        a.pull(s, a.available(s))
    snap = a.snapshot()
    assert snap["debt"][lanes[2]] > 0

    b = pool(new_size)
    lane_map = b.restore(snap, resize=True)
    assert sorted(lane_map) == sorted(lanes)
    assert sorted(lane_map.values()) == [0, 1, 2]
    assert sorted(b._attached) == [0, 1, 2]
    assert b._reset_pending[3:].all()
    feed(a, lanes, sigs, range(4, 8))
    feed(b, [lane_map[s] for s in lanes], {lane_map[s]: sigs[s] for s in lanes},
         range(4, 8))
    for s in lanes:
        want = a.pull(s, a.available(s))
        assert want.shape[1] > 0
        np.testing.assert_array_equal(b.pull(lane_map[s], want.shape[1]), want)
    extra = b.attach()
    x = (np.random.default_rng(3).standard_normal((2, BLOCK)) * 0.3).astype(np.float32)
    b.push(extra, x)
    b.pump()
    fresh = pool(2)
    f = fresh.attach()
    fresh.push(f, x)
    fresh.pump()
    # Not bit for bit: b's ring cursor is not at 0, so the MAC sums the
    # partitions in another order. Filler left in the lane would be O(1).
    assert rel_rms(b.pull(extra, BLOCK), fresh.pull(f, BLOCK)) <= 1e-6


def test_resize_paged_tier_with_debt():
    """tests/test_resize.py:118 on the port: pages gather on the lane axis
    and page-granular debt rides along."""
    M = 2
    a = pool(4, M)
    s0, s1 = a.attach(), a.attach()
    L = a.step_frames
    sigs = signals([s0, s1], 6, L)
    feed(a, [s0, s1], sigs, range(4), skip={(s1, 2), (s1, 3)})
    for s in (s0, s1):
        a.pull(s, a.available(s))
    snap = a.snapshot()
    assert snap["debt"][s1] > 0
    b = pool(8, M)
    lane_map = b.restore(snap, resize=True)
    for p, ids in ((a, {s0: s0, s1: s1}), (b, lane_map)):
        for i in range(4, 6):
            p.push(ids[s0], sigs[s0][:, i * L:(i + 1) * L])
        for i in range(2, 6):
            p.push(ids[s1], sigs[s1][:, i * L:(i + 1) * L])
        p.pump()
        p.pump()
        p.pump()
    # As in the JAX test, not bit for bit: the paged step's matmuls take the
    # lane count as a dimension, and another count re-tiles their float
    # reductions (as running the lanes in the larger pool from the start).
    for s in (s0, s1):
        want = a.pull(s, a.available(s))
        assert want.shape[1] > 0
        np.testing.assert_allclose(b.pull(lane_map[s], want.shape[1]), want,
                                   atol=1e-5)


def test_bad_snapshots_leave_the_pool_unchanged():
    """tests/test_resize.py:100 and the strict checks: a resize that does
    not fit, a size mismatch without resize, the other tier, a grouped
    snapshot and an EQ definition that does not design all raise before
    anything changes; the pool then renders as its untouched twin."""
    a, twin = pool(4, eq=preset(1.0)), pool(4, eq=preset(1.0))
    lanes = [a.attach() for _ in range(3)]
    assert [twin.attach() for _ in range(3)] == lanes
    sigs = signals(lanes, 6, BLOCK)
    for p in (a, twin):
        feed(p, lanes, sigs, range(3))
    big = pool(6)
    for _ in range(3):
        big.attach()
    paged = pool(4, 2)
    paged.attach()
    bad_eq = a.snapshot()
    bad_eq["eq_runtime"] = dict(bad_eq["eq_runtime"])
    bad_def = tapo.EqualizerDefinition(0.0, (tapo.EqualizerFilter(
        1, 1, True, tapo.FilterType.PEAKING, 30_000.0, 3.0, 1.0),))
    bad_eq["eq_runtime"]["active"] = ("prepared", bad_def, ((), ()))
    small = pool(2)
    with pytest.raises(ValueError, match="3 attached lanes"):
        small.restore(big.snapshot(), resize=True)
    assert not small._attached
    for snap, error, match in (
            (big.snapshot(), ValueError, "mismatch"),
            (paged.snapshot(), ValueError, "mismatch"),
            ({**a.snapshot(), "groups": 2}, ValueError, "profile groups"),
            (bad_eq, EqInvalidFilter, None)):
        with pytest.raises(error, match=match):
            a.restore(snap)
    feed(a, lanes, sigs, range(3, 6))
    feed(twin, lanes, sigs, range(3, 6))
    for s in lanes:
        np.testing.assert_array_equal(a.pull(s, 6 * BLOCK), twin.pull(s, 6 * BLOCK))


def test_state_like_allocates_nothing():
    for M in (1, 2):
        p = pool(4, M)
        like = p.state_like(10)
        for name, t in [("debt", like["debt"])] + list(zip(
                like["state"].eq._fields, like["state"].eq)):
            assert t.device.type == "meta", name
            assert t.shape[0] == 10, name
        conv = like["state"].conv
        carry = conv.pages if M > 1 else (conv.fdl,)
        real = p._state.conv.pages if M > 1 else (p._state.conv.fdl,)
        for t, r in zip(carry, real):
            assert t.device.type == "meta" and t.dtype == r.dtype
            assert t.shape == r.shape[:-1] + (10,)


# --- between the packages ----------------------------------------------------------


def jax_carry(state):
    """The JAX pool's carry NamedTuples from the port's numpy ones (the
    field names are the same)."""
    conv = state.conv
    conv = (jupols.PagedConvState(pages=tuple(conv.pages))
            if hasattr(conv, "pages")
            else jupols.ConvState(fdl=conv.fdl, write_pos=conv.write_pos))
    return jsp.PoolState(conv=conv, eq=jeq.EqState(*state.eq))


@pytest.mark.parametrize("M", [1, 2])
def test_snapshots_move_between_jax_and_port_pools(M):
    """A JAX pool's snapshot (mid EQ ramp, lanes owing debt) resumes in the
    port's pool, and the port's later snapshot resumes in a JAX pool; each
    continuation agrees with the pool it was taken from within 1e-5."""
    wav = audio(11, 700)
    jpool = jsp.StreamPool(3, SR, jprepare(JWAVData(SR, wav), jcm.STEREO, SR,
                                           BLOCK, lookahead=M),
                           eq_definition=japo.parse(preset(2.0), "e"),
                           block_size=BLOCK, blocks_per_step=M, ring_blocks=64)
    tpool = StreamPool(3, SR, tprepare(TWAVData(SR, wav), tcm.STEREO, SR, BLOCK,
                                       lookahead=M, device="cpu"),
                       eq_definition=tapo.parse(preset(2.0), "e"),
                       block_size=BLOCK, blocks_per_step=M, ring_blocks=64,
                       device="cpu")
    lanes = [jpool.attach() for _ in range(3)]
    L = tpool.step_frames
    sigs = signals(lanes, 30, L, seed=31)
    skip = {(lanes[(i % 3)], i) for i in range(30) if i % 4 == 1}

    def run(p, rounds):
        feed(p, lanes, sigs, rounds, skip)
        return {s: p.pull(s, p.available(s)) for s in lanes}

    run(jpool, range(8))
    jpool.set_equalizer(japo.parse(preset(-3.0), "b"))
    run(jpool, range(8, 10))
    snap = jpool.snapshot()
    assert snap["eq_runtime"]["transition_from"] is not None
    assert any(snap["debt"][s] for s in lanes)
    tpool.restore(interop.pool_snapshot_from_numpy(snap, device="cpu"))
    outs_j, outs_t = run(jpool, range(10, 25)), run(tpool, range(10, 25))
    for s in lanes:
        assert outs_t[s].shape[1] > 0
        assert rel_rms(outs_t[s], outs_j[s]) <= TOL, s

    back = interop.pool_snapshot_to_numpy(tpool.snapshot(), japo, jbd)
    back["state"] = jax_carry(back["state"])
    jback = jsp.StreamPool(3, SR, jpool.renderer,
                           eq_definition=japo.parse(preset(2.0), "e"),
                           block_size=BLOCK, blocks_per_step=M, ring_blocks=64)
    jback.restore(back)
    outs_b, outs_t = run(jback, range(25, 30)), run(tpool, range(25, 30))
    for s in lanes:
        assert outs_t[s].shape[1] > 0
        assert rel_rms(outs_t[s], outs_b[s]) <= TOL, s
