"""runtime/stream_pool of the PyTorch port against the JAX StreamPool: both
pools (the port's on the CPU, its kernels' plain versions) are driven by the
same seeded ragged traffic, and every stream's output must agree within
1e-5 rel-RMS; the ragged case is also held against the float64 oracles."""

import numpy as np
import pytest
import torch

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io import apo as japo
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu.oracle.upols_oracle import UPOLSOracle
from airwave_tpu.runtime.stream_pool import StreamPool as JPool
from airwave_tpu_torch import interop
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.runtime import stream_pool as tsp

SR = 48_000.0
BLOCK = 64
TOL = 1e-5          # per stream, port pool vs JAX pool and vs float64
RAMP = 960          # the 20 ms crossfade at 48 kHz


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)),
                                                  1e-30)


def preset(gain: float) -> bytes:
    return (f"Preamp: -1.0 dB\nFilter 1: ON PK Fc 900 Hz Gain {gain} dB Q 1.0\n"
            f"Filter 2: ON LSC Fc 120 Hz Gain -2.5 dB Q 0.7\n").encode()


class Pair:
    """A JAX pool and the port's pool (on the CPU) built from the same HRIR
    bank and preset, and driven call for call with the same data."""

    def __init__(self, max_streams, gain=None, lookahead=1, seed=5,
                 frames=700, **kw):
        rng = np.random.default_rng(seed)
        self.audio = (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)
        jr = jprepare(JWAVData(SR, self.audio), jcm.STEREO, SR, BLOCK,
                      lookahead=lookahead)
        tr = tprepare(TWAVData(SR, self.audio), tcm.STEREO, SR, BLOCK,
                      lookahead=lookahead, device="cpu")
        jeq = teq = None
        if gain is not None:
            jeq = japo.parse(preset(gain), "eq.txt")
            teq = tapo.parse(preset(gain), "eq.txt")
        self.j = JPool(max_streams, SR, jr, eq_definition=jeq,
                       block_size=BLOCK, blocks_per_step=lookahead, **kw)
        self.t = tsp.StreamPool(max_streams, SR, tr, eq_definition=teq,
                                block_size=BLOCK, blocks_per_step=lookahead,
                                device="cpu", **kw)
        self.step = self.t.step_frames

    def attach(self):
        a, b = self.j.attach(), self.t.attach()
        assert a == b
        return a

    def detach(self, s):
        self.j.detach(s)
        self.t.detach(s)

    def push(self, s, chunk):
        self.j.push(s, chunk)
        self.t.push(s, chunk)

    def pump(self):
        assert self.j.pump() == self.t.pump()

    def pull(self, s, n):
        return self.j.pull(s, n), self.t.pull(s, n)

    def set_equalizer(self, gain):
        self.j.set_equalizer(japo.parse(preset(gain), "eq.txt"))
        self.t.set_equalizer(tapo.parse(preset(gain), "eq.txt"))

    def settle(self, streams):
        """Run the construction-time unity->target ramp to its end on
        silence, so what follows starts from zero history at the target."""
        for _ in range(RAMP // self.step + 3):
            for s in streams:
                self.push(s, np.zeros((2, self.step), np.float32))
            self.pump()
            for s in streams:
                self.pull(s, self.step)


def oracle_stream(audio, sig, coeffs=None, preamp=1.0):
    """float64 reference of one stream: UPOLS per speaker and ear (hesuvi14
    map of the stereo layout), summed, then the EQ cascade from rest."""
    m = jcm.hesuvi_14_channel(jcm.STEREO.channels)
    n = sig.shape[-1]
    dry = np.zeros((2, n))
    for spk, speaker in enumerate((jcm.FL, jcm.FR)):
        for ear, ch in zip((0, 1), m.indices(speaker)):
            o = UPOLSOracle(audio[ch], BLOCK)
            dry[ear] += np.concatenate([o.process(sig[spk, i:i + BLOCK])
                                        for i in range(0, n, BLOCK)])
    if coeffs is None:
        return dry
    left, right = EqCascadeOracle(coeffs, preamp, SR).process(
        dry[0].astype(np.float32), dry[1].astype(np.float32))
    return np.stack([left, right])


def test_ragged_pauses_with_debt_rolls_match_jax_and_oracles():
    """Streams starve at different rounds (stream 2 for longer than a cursor
    lap): every stream matches the JAX pool and its own float64 chain."""
    pair = Pair(4, gain=3.0)
    streams = [pair.attach() for _ in range(3)]
    pair.settle(streams)
    rng = np.random.default_rng(21)
    n_blocks = 12
    sigs = [(rng.standard_normal((2, n_blocks * BLOCK)) * 0.3).astype(np.float32)
            for _ in streams]
    fed = [0, 0, 0]
    for rnd in range(120):
        if min(fed) >= n_blocks:
            break
        feeds = [True, rnd % 2 == 0, rnd % 24 < 3 or rnd >= 60]
        for i, s in enumerate(streams):
            if feeds[i] and fed[i] < n_blocks:
                pair.push(s, sigs[i][:, fed[i] * BLOCK:(fed[i] + 1) * BLOCK])
                fed[i] += 1
        pair.pump()
    stats = pair.t.stats()
    assert stats["debt_rolls"] > 0
    assert {"ring", "ring_all"} <= set(stats["variant_rounds"])
    preamp, coeffs = tbd.design_cascade(tapo.parse(preset(3.0), "eq.txt"), SR)
    for i, s in enumerate(streams):
        got_j, got_t = pair.pull(s, n_blocks * BLOCK)
        assert rel_rms(got_t, got_j) <= TOL, i
        ref = oracle_stream(pair.audio, sigs[i], coeffs, preamp)
        assert rel_rms(got_t, ref) <= TOL, i


@pytest.mark.parametrize("M", [1, 2])
def test_saturated_rounds_select_identity_variant(M):
    """A full pool with every lane fed steps through ring_id (paged_id); a
    half-full one through ring_all (paged_all); a pool with an idle lane
    attached through the masked variant. All three render the same audio,
    and match the JAX pools."""
    B, n = 4, 4
    full, half, masked = (Pair(B, 2.0, lookahead=M), Pair(2 * B, 2.0, lookahead=M),
                          Pair(B + 1, 2.0, lookahead=M))
    streams = [[p.attach() for _ in range(B)] for p in (full, half, masked)]
    masked.attach()  # attached and never fed
    rng = np.random.default_rng(23)
    x = (rng.standard_normal((B, 2, n * full.step)) * 0.3).astype(np.float32)
    for i in range(n):
        for p, ss in zip((full, half, masked), streams):
            for j, s in enumerate(ss):
                p.push(s, x[j, :, i * p.step:(i + 1) * p.step])
            p.pump()
    tier = "paged" if M > 1 else "ring"
    outs = []
    for p, ss, variant in zip((full, half, masked), streams,
                              (f"{tier}_id", f"{tier}_all", tier)):
        assert set(p.t.stats()["variant_rounds"]) == {variant}
        pulled = [p.pull(s, n * p.step) for s in ss]
        got_j = np.stack([a for a, _ in pulled])
        got_t = np.stack([b for _, b in pulled])
        assert rel_rms(got_t, got_j) <= TOL, variant
        outs.append(got_t)
    assert np.any(outs[0] != 0)
    for other in outs[1:]:
        assert rel_rms(other, outs[0]) <= 1e-6


@pytest.mark.parametrize("M", [1, 2])
def test_three_retargets_match_jax(M):
    """Four retargets, one per ramp, with a second lane pausing mid-ramp:
    the pool drains the EQ retirement handoff every round, so the third
    and later retargets are not wedged, and the audio matches JAX."""
    pair = Pair(2, gain=1.0, lookahead=M)
    a, b = pair.attach(), pair.attach()
    rng = np.random.default_rng(0)
    rounds_per_ramp = -(-RAMP // pair.step) + 3
    outs = {a: [], b: []}
    for i, gain in enumerate((2.0, 3.0, 4.0, 5.0)):
        pair.set_equalizer(gain)
        for r in range(rounds_per_ramp):
            for s in (a, b):
                if s == a or r % 3 != 1:
                    pair.push(s, (rng.standard_normal((2, pair.step)) * 0.3
                                  ).astype(np.float32))
            pair.pump()
            for s in (a, b):
                n = pair.t.available(s)
                assert n == pair.j.available(s)
                outs[s].append(pair.pull(s, n))
        rt = pair.t.eq_runtime
        assert rt.active.definition == tapo.parse(preset(gain), "eq.txt"), i
        assert rt.pending_target is None and not rt.is_transitioning, i
    for s in (a, b):
        got_j = np.concatenate([o[0] for o in outs[s]], 1)
        got_t = np.concatenate([o[1] for o in outs[s]], 1)
        assert rel_rms(got_t, got_j) <= TOL, s


def test_attach_detach_recycles_cleanly():
    pair = Pair(4, gain=2.0)
    s1 = pair.attach()
    pair.push(s1, np.ones((2, BLOCK), np.float32))
    pair.pump()
    assert pair.t.available(s1) == BLOCK
    pair.detach(s1)
    s2 = pair.attach()
    assert s2 == s1 and pair.t.available(s2) == 0
    # Fresh state: silence in, silence out; then both pools agree.
    pair.push(s2, np.zeros((2, BLOCK), np.float32))
    pair.pump()
    np.testing.assert_array_equal(pair.t.pull(s2, BLOCK), 0)
    pair.j.pull(s2, BLOCK)
    sig = (np.random.default_rng(4).standard_normal((2, 3 * BLOCK)) * 0.3
           ).astype(np.float32)
    pair.push(s2, sig)
    pair.pump()
    got_j, got_t = pair.pull(s2, 3 * BLOCK)
    assert rel_rms(got_t, got_j) <= TOL
    with pytest.raises(RuntimeError, match="full"):
        for _ in range(4):
            pair.t.attach()


def test_slow_reader_backpressure_without_loss():
    """pump defers harvesting a stream whose output ring is full, so
    backpressure reaches the producer through the input ring while every
    rendered block stays intact and ordered."""
    pair = Pair(2, ring_blocks=2)
    roomy = Pair(2, ring_blocks=16)
    s, f = pair.attach(), roomy.attach()
    audio = (np.random.default_rng(9).standard_normal((2, 6 * BLOCK)) * 0.4
             ).astype(np.float32)

    def feed(i):
        pair.t.push(s, audio[:, i * BLOCK:(i + 1) * BLOCK])
        pair.t.pump()
        roomy.t.push(f, audio[:, i * BLOCK:(i + 1) * BLOCK])
        roomy.t.pump()

    for i in range(4):
        feed(i)
    assert pair.t.available(s) == 2 * BLOCK
    with pytest.raises(OverflowError):
        pair.t.push(s, audio[:, 4 * BLOCK:5 * BLOCK])
    got = [pair.t.pull(s, 2 * BLOCK)]
    pair.t.pump()
    for i in range(4, 6):
        feed(i)
        got.append(pair.t.pull(s, pair.t.available(s)))
    got.append(pair.t.pull(s, 6 * BLOCK - sum(g.shape[1] for g in got)))
    got = np.concatenate(got, axis=1)
    want = roomy.t.pull(f, 6 * BLOCK)
    np.testing.assert_allclose(got, want, atol=1e-6)
    roomy.j.push(f, audio)
    roomy.j.pump()
    assert rel_rms(got, roomy.j.pull(f, 6 * BLOCK)) <= TOL
    assert pair.t.available(s) == 0
    pair.t.detach(s)
    assert not pair.t._pending_out


def test_paged_tier_ragged_matches_jax():
    """blocks_per_step=2: ragged pauses (page-granular debt rolls), the
    folded EQ in steady state, and a retarget through the unfused path."""
    M, B = 2, 4
    pair = Pair(B, gain=-2.0, lookahead=M)
    streams = [pair.attach() for _ in range(B)]
    pair.settle(streams)
    rng = np.random.default_rng(0)
    n = 10
    x = (rng.standard_normal((B, 2, n * pair.step)) * 0.3).astype(np.float32)
    fed = [0] * B
    for rnd in range(6 * n):
        if min(fed) >= n:
            break
        if rnd == 9:
            pair.set_equalizer(4.0)
        for j, s in enumerate(streams):
            if fed[j] < n and (j == 0 or rnd % (j + 2) != 0):
                pair.push(s, x[j, :, fed[j] * pair.step:(fed[j] + 1) * pair.step])
                fed[j] += 1
        pair.pump()
    stats = pair.t.stats()
    assert stats["debt_rolls"] > 0
    assert {"paged", "paged_id"} <= set(stats["variant_rounds"])
    assert stats["blocks_rendered"] == pair.j.blocks_rendered
    for s in streams:
        got_j, got_t = pair.pull(s, n * pair.step)
        assert rel_rms(got_t, got_j) <= TOL, s


@pytest.mark.parametrize("M", [1, 2])
def test_prewarm_is_a_semantic_noop(M):
    """prewarm() runs every variant on a throwaway state; called before
    traffic and mid-life it leaves every stream's audio unchanged."""
    warm, plain = Pair(4, 2.0, lookahead=M), Pair(4, 2.0, lookahead=M)
    s_w, s_p = warm.t.attach(), plain.t.attach()
    warm.t.prewarm()
    sig = (np.random.default_rng(11).standard_normal((2, 4 * warm.step)) * 0.3
           ).astype(np.float32)
    for i in range(4):
        warm.t.push(s_w, sig[:, i * warm.step:(i + 1) * warm.step])
        plain.t.push(s_p, sig[:, i * warm.step:(i + 1) * warm.step])
        warm.t.pump()
        plain.t.pump()
        if i == 1:
            warm.t.prewarm()
    np.testing.assert_array_equal(warm.t.pull(s_w, 4 * warm.step),
                                  plain.t.pull(s_p, 4 * warm.step))


def _finish_port_ramp(pool):
    """Advance the port pool's EQ machine through its construction-time
    ramp without rendering, so it stands where the settled JAX one does."""
    rt = pool.eq_runtime
    eq, *_ = rt.begin_block(pool._state.eq)
    rt.after_block(rt.transition_length)
    eq, *_ = rt.begin_block(eq)
    assert not rt.is_transitioning and rt.pending_target is None


@pytest.mark.parametrize("M", [1, 2])
def test_jax_pool_carry_continues_in_port_pool(M):
    """A JAX pool renders the first half of ragged traffic; its carry (conv
    and EQ) and alignment debt move through interop into the port's pool,
    which renders the second half as the JAX pool does."""
    pair = Pair(3, gain=2.0, lookahead=M)
    jpool, tpool = pair.j, pair.t
    streams = [jpool.attach() for _ in range(3)]
    for _ in range(RAMP // pair.step + 3):  # the JAX pool's ramp ends
        jpool.push_many(streams, np.zeros((3, 2, pair.step), np.float32))
        jpool.pump()
        jpool.pull_many(streams, pair.step)
    rng = np.random.default_rng(31)
    chunks = [[(rng.standard_normal((2, pair.step)) * 0.3).astype(np.float32)
               for _ in streams] for _ in range(24)]

    def run(pool, rounds):
        outs = []
        for rnd in rounds:
            for j, s in enumerate(streams):
                if (rnd + j) % 3:
                    pool.push(s, chunks[rnd][j])
            pool.pump()
            outs.append([pool.pull(s, pool.available(s)) for s in streams])
        return outs

    run(jpool, range(12))
    assert (jpool._debt[streams] != 0).any()
    for s in streams:
        assert tpool.attach() == s
    tpool._flush_attach_resets()
    _finish_port_ramp(tpool)
    tpool._state = interop.pool_state_from_numpy(jpool._state, device="cpu")
    tpool._debt[:] = jpool._debt
    back = interop.pool_state_to_numpy(tpool._state)
    conv_j = jpool._state.conv.pages if M > 1 else (jpool._state.conv.fdl,)
    conv_t = back.conv.pages if M > 1 else (back.conv.fdl,)
    for a, b in zip(conv_t, conv_j):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(back.eq.counter, np.asarray(jpool._state.eq.counter))

    got_j, got_t = run(jpool, range(12, 24)), run(tpool, range(12, 24))
    for j in range(len(streams)):
        a = np.concatenate([o[j] for o in got_j], 1)
        b = np.concatenate([o[j] for o in got_t], 1)
        assert a.shape == b.shape and a.shape[1] > 0
        assert rel_rms(b, a) <= TOL, j


def test_renderer_from_numpy_drives_the_port_pool():
    """A JAX RendererState moved by interop renders as the port's own."""
    pair = Pair(2, gain=1.5)
    moved = interop.renderer_from_numpy(pair.j.renderer, device="cpu")
    for a, b in zip(moved.conv_params, pair.t.renderer.conv_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert moved.speakers == pair.t.renderer.speakers
    assert moved.input_indices == pair.t.renderer.input_indices


def test_pump_failure_rebuilds_state_and_reraises(monkeypatch):
    pair = Pair(2, gain=2.0)
    s = pair.t.attach()
    pair.t.push(s, np.ones((2, 2 * BLOCK), np.float32))
    pair.t.pump(max_rounds=1)
    assert pair.t._state.conv.fdl.any()

    def boom(*args, **kwargs):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(tupols, "conv_step", boom)
    with pytest.raises(RuntimeError, match="injected"):
        pair.t.pump()
    assert pair.t.render_errors == 1
    assert not pair.t._state.conv.fdl.any()
    monkeypatch.undo()
    pair.t.push(s, np.ones((2, BLOCK), np.float32))
    assert pair.t.pump() == 1


@pytest.mark.parametrize("call, error, match", [
    (lambda p: tsp.StreamPool(2, SR, p.renderer, profiles=[p.renderer],
                              device="cpu"), ValueError, "not both"),
    (lambda p: p.set_renderer(p.renderer, group=1), ValueError,
     "group 1 out of range for a single-profile pool"),
], ids=["profiles", "set_renderer"])
def test_unported_features_raise(call, error, match):
    """Profile groups are ported (tests/test_torch_grouped.py): a renderer
    passed beside profiles, and a hot-swap of a group a one-profile pool
    does not have, raise the JAX pool's ValueError."""
    pool = Pair(2).t
    with pytest.raises(error, match=match):
        call(pool)


def test_paged_tier_validates_renderer_lookahead():
    pair = Pair(2)
    with pytest.raises(ValueError, match="lookahead=2"):
        tsp.StreamPool(2, SR, pair.t.renderer, block_size=BLOCK,
                       blocks_per_step=2, device="cpu")
