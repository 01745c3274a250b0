"""The HRIR hot-swap of the PyTorch port against the JAX package: the bank ops
of ops/upols, models/binaural.BinauralEngine and StreamPool.set_renderer on
both tiers. The port runs on the CPU (its kernels' plain versions) on the
same seeded inputs as the JAX engine and pools; outputs agree within 1e-5
rel-RMS, the bank ops within 1e-6 (xfade_ramp bit for bit), and both are
held against the np.convolve time-varying oracle of tests/test_hotswap.py:

    y(t) = (1 - r(t)) * (h_old * x)(t) + r(t) * (h_new * x)(t)

over the full input history, r rising (i+1)/fade from the lane's fade."""

import numpy as np
import pytest
import torch

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph.renderer import RendererState as JRendererState
from airwave_tpu.graph.renderer import build_hrir_time_domain
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io import apo as japo
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.models.binaural import BinauralEngine as JEngine
from airwave_tpu.ops import upols as jupols
from airwave_tpu.runtime.stream_pool import StreamPool as JPool
from airwave_tpu_torch import interop
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import RendererState as TRendererState
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.models.binaural import BinauralEngine as TEngine
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.runtime.stream_pool import StreamPool as TPool
from airwave_tpu_torch.runtime.stream_pool import _carry_leaves

BLOCK = 64
SR = 4800.0      # engine: the 20 ms fade is 96 samples, two 64-sample blocks
SR48 = 48_000.0  # pools: the fade is min(960, one round)
FADE = 96
TOL = 1e-5       # port vs JAX, and vs the oracle (the chain contract)
OP_TOL = 1e-6    # bank ops, port vs JAX


def rel_rms(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((y - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def full_conv(x: np.ndarray, hrir: np.ndarray) -> np.ndarray:
    """Oracle: y[e, t] = sum_s (x_s * h[s, e])(t), f64, full history."""
    n = x.shape[-1]
    y = np.zeros((hrir.shape[1], n))
    for s in range(hrir.shape[0]):
        for e in range(hrir.shape[1]):
            y[e] += np.convolve(x[s].astype(np.float64),
                                hrir[s, e].astype(np.float64))[:n]
    return y


def ramp(n: int, start: int, fade: int) -> np.ndarray:
    """Blend weight per sample: 0 before `start`, then (i+1)/fade, clipped."""
    r = np.zeros(n)
    r[start:] = np.minimum((np.arange(n - start) + 1) / fade, 1.0)
    return r


def lane_ref(x, h_old, h_new, fade_start, fade):
    r = ramp(x.shape[-1], fade_start, fade)
    return (1.0 - r) * full_conv(x, h_old) + r * full_conv(x, h_new)


def bank_pair(hrir, lookahead=1, block=BLOCK):
    """The JAX ConvParams and the port's (CPU) of one HRIR bank."""
    kw = dict(pad_to_pow2=False, lookahead=lookahead)
    return (jupols.make_conv_params(hrir, block, **kw),
            tupols.make_conv_params(hrir, block, device="cpu", **kw))


def renderer_pair(hrir):
    jp, tp = bank_pair(hrir)
    speakers = tuple(f"S{i}" for i in range(hrir.shape[0]))
    return (JRendererState(conv_params=jp, speakers=speakers, sample_rate=SR,
                           block_size=BLOCK),
            TRendererState(conv_params=tp, speakers=speakers, sample_rate=SR,
                           block_size=BLOCK))


# --- bank ops ------------------------------------------------------------------


def test_bank_ops_match_jax():
    rng = np.random.default_rng(1)
    h_a = rng.standard_normal((2, 2, 150)).astype(np.float32)
    h_b = rng.standard_normal((2, 2, 100)).astype(np.float32)
    (ja, ta), (jb, tb) = bank_pair(h_a), bank_pair(h_b)
    P = ja.partition_count
    jb_pad, tb_pad = jupols.pad_conv_params(jb, P), tupols.pad_conv_params(tb, P)
    np.testing.assert_array_equal(tb_pad.Gflip2.numpy(), np.asarray(jb_pad.Gflip2))
    for jop, top in ((jupols.xfade_conv_params, tupols.xfade_conv_params),
                     (lambda a, b: jupols.lerp_bank(a, b, 0.37),
                      lambda a, b: tupols.lerp_bank(a, b, 0.37))):
        want, got = jop(ja, jb_pad), top(ta, tb_pad)
        for a, b in zip(got, want):
            assert rel_rms(a.numpy(), np.asarray(b)) <= OP_TOL
        assert got.wf is tb_pad.wf and got.wi is tb_pad.wi
    assert tupols.xfade_conv_params(ta, tb_pad).num_ears == 4
    with pytest.raises(ValueError, match="pad_conv_params can grow"):
        tupols.xfade_conv_params(ta, tb)
    with pytest.raises(ValueError, match="lerp banks"):
        tupols.lerp_bank(ta, tb, 0.5)
    for fade, total in ((96, 128), (960, 512), (1, 5), (0, 3)):
        np.testing.assert_array_equal(tupols.xfade_ramp(fade, total),
                                      jupols.xfade_ramp(fade, total))
    y3 = rng.standard_normal((5, 4, BLOCK)).astype(np.float32)
    y4 = rng.standard_normal((5, 3, 4, BLOCK)).astype(np.float32)
    mask = np.array([True, False, True, True, False])
    for y, n in ((y3, BLOCK), (y4, 3 * BLOCK)):
        r = jupols.xfade_ramp(40, n)
        for m in (None, mask):
            want = jupols.xfade_blend(y, r, m)
            got = tupols.xfade_blend(torch.from_numpy(y), torch.from_numpy(r),
                                     None if m is None else torch.from_numpy(m))
            assert got.shape == want.shape
            assert rel_rms(got.numpy(), np.asarray(want)) <= OP_TOL


@pytest.mark.parametrize("M", [1, 8])
def test_dual_bank_layout_is_what_the_kernels_read(M):
    """single_block_bank and paged_bank of the dual bank: O = (E, Q) = 8
    columns (single block) and O = (M, E, Q) = 64 at M = 8, each ear half
    the old or new bank's own operand, so one MAC gives both outputs."""
    rng = np.random.default_rng(M)
    _, old = bank_pair(rng.standard_normal((2, 2, 300)).astype(np.float32), M)
    _, new = bank_pair(rng.standard_normal((2, 2, 300)).astype(np.float32), M)
    dual = tupols.xfade_conv_params(old, new)
    Kp = tupols.padded_bin_count(BLOCK)
    if M == 1:
        banks = [tupols.single_block_bank(p, Kp) for p in (dual, old, new)]
        assert banks[0].shape[1] == 8
        split = [b.reshape(Kp, -1, 2, *b.shape[2:]) for b in banks]
        ear_axis = 1
    else:
        banks = [tupols.paged_bank(p, M, Kp) for p in (dual, old, new)]
        assert banks[0].shape[2] == 64
        split = [b.reshape(b.shape[0], Kp, M, -1, 2, b.shape[-1]) for b in banks]
        ear_axis = 3
    d, o, n = split
    torch.testing.assert_close(d.narrow(ear_axis, 0, 2), o, rtol=0, atol=0)
    torch.testing.assert_close(d.narrow(ear_axis, 2, 2), n, rtol=0, atol=0)


def test_pad_conv_params_is_the_same_filter():
    """A padded bank renders what the unpadded one does (tail partitions
    convolve nothing), and equals the JAX pad bit for bit."""
    rng = np.random.default_rng(15)
    h = rng.standard_normal((2, 2, 100)).astype(np.float32)
    jbase, base = bank_pair(h)
    padded = tupols.pad_conv_params(base, base.partition_count + 3)
    np.testing.assert_array_equal(
        padded.Gflip2.numpy(),
        np.asarray(jupols.pad_conv_params(jbase, base.partition_count + 3).Gflip2))
    assert tupols.pad_conv_params(base, base.partition_count) is base
    x = torch.from_numpy(rng.standard_normal((1, 2, 4 * BLOCK)).astype(np.float32))
    ys = []
    for p in (base, padded):
        st = tupols.make_conv_state(1, 2, p.partition_count, BLOCK, "cpu")
        out = []
        for b in range(4):
            st, y = tupols.conv_step(p, st, x[:, :, b * BLOCK:(b + 1) * BLOCK])
            out.append(y.numpy())
        ys.append(np.concatenate(out, -1))
    assert rel_rms(ys[1], ys[0]) <= OP_TOL
    with pytest.raises(ValueError, match="cannot shrink"):
        tupols.pad_conv_params(base, base.partition_count - 1)


# --- BinauralEngine ------------------------------------------------------------

ENGINE_CASES = {
    # name: (bank lengths, blocks, {block: (bank, crossfade, crossfaded?)})
    "shorter_bank_crossfades": ((150, 100), 9, {3: (1, True, True)}),
    "no_crossfade_resets": ((150, 150), 8, {4: (1, False, False)}),
    "second_swap_mid_fade": ((130, 130, 130), 10,
                             {3: (1, True, True), 4: (2, True, True)}),
    "longer_bank_resets": ((100, 400), 6, {3: (1, True, False)}),
}


def engine_oracle(case, banks, x):
    """The ideal trajectory of each case (tests/test_hotswap.py:74-190)."""
    n = x.shape[-1]
    ys = [full_conv(x, h) for h in banks]
    if case == "shorter_bank_crossfades":
        r = ramp(n, 3 * BLOCK, FADE)
        return (1.0 - r) * ys[0] + r * ys[1]
    if case == "no_crossfade_resets":
        t = 4 * BLOCK
        return np.concatenate([ys[0][:, :t], full_conv(x[:, t:], banks[1])], 1)
    if case == "longer_bank_resets":
        t = 3 * BLOCK
        return np.concatenate([ys[0][:, :t], full_conv(x[:, t:], banks[1])], 1)
    # Newest-wins restart from the blend frozen at the ramp value the next
    # sample would have used, then faded to the newest bank.
    t2, r0 = 4 * BLOCK, (BLOCK + 1) / FADE
    r1, r2 = ramp(n, 3 * BLOCK, FADE), ramp(n, t2, FADE)
    ref = (1.0 - r1) * ys[0] + r1 * ys[1]
    frozen = (1.0 - r0) * ys[0] + r0 * ys[1]
    ref[:, t2:] = ((1.0 - r2) * frozen + r2 * ys[2])[:, t2:]
    return ref


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_swaps_match_jax_and_oracle(case):
    lengths, n_blocks, swaps = ENGINE_CASES[case]
    rng = np.random.default_rng(len(case))
    banks = [(rng.standard_normal((2, 2, n)) * 0.3).astype(np.float32)
             for n in lengths]
    renderers = [renderer_pair(h) for h in banks]
    B = 2
    x = (rng.standard_normal((B, 2, n_blocks * BLOCK)) * 0.5).astype(np.float32)
    jeng = JEngine(B, SR, BLOCK, renderer=renderers[0][0])
    teng = TEngine(B, SR, BLOCK, renderer=renderers[0][1], device="cpu")
    outs = ([], [])
    for b in range(n_blocks):
        if b in swaps:
            bank, crossfade, faded = swaps[b]
            assert jeng.set_renderer(renderers[bank][0], crossfade) is faded
            assert teng.set_renderer(renderers[bank][1], crossfade) is faded
        xb = x[:, :, b * BLOCK:(b + 1) * BLOCK]
        outs[0].append(np.asarray(jeng.process_block(xb)))
        outs[1].append(teng.process_block(xb))
    y_j, y_t = (np.concatenate(o, -1) for o in outs)
    assert np.isfinite(y_t).all()
    assert rel_rms(y_t, y_j) <= TOL
    for lane in range(B):
        assert rel_rms(y_t[lane], engine_oracle(case, banks, x[lane])) <= TOL
    assert teng._xfade_params is None and not teng._xfade_segments


def test_engine_eq_swap_and_passthrough_match_jax():
    """A swap under a live EQ (the blend drives the EQ), an EQ retarget
    during the fade, a reset, and the passthrough topology (no renderer:
    stereo forwarded, mono duplicated), each as the JAX engine renders it."""
    rng = np.random.default_rng(5)
    banks = [(rng.standard_normal((2, 2, 200)) * 0.3).astype(np.float32)
             for _ in range(2)]
    renderers = [renderer_pair(h) for h in banks]
    defs = [f"Preamp: -2 dB\nFilter 1: ON PK Fc {f} Hz Gain 4 dB Q 1.0\n".encode()
            for f in (500, 900)]
    B, n_blocks = 3, 10
    x = (rng.standard_normal((B, 2, n_blocks * BLOCK)) * 0.5).astype(np.float32)
    jeng = JEngine(B, SR, BLOCK, renderer=renderers[0][0])
    teng = TEngine(B, SR, BLOCK, renderer=renderers[0][1], device="cpu")
    jeng.prepare_equalizer(japo.parse(defs[0], "a.txt"))
    teng.prepare_equalizer(tapo.parse(defs[0], "a.txt"))
    outs = ([], [])
    for b in range(n_blocks):
        if b == 3:
            assert jeng.set_renderer(renderers[1][0]) is True
            assert teng.set_renderer(renderers[1][1]) is True
        if b == 4:
            jeng.set_equalizer(japo.parse(defs[1], "b.txt"))
            teng.set_equalizer(tapo.parse(defs[1], "b.txt"))
        if b == 7:
            jeng.reset()
            teng.reset()
        xb = x[:, :, b * BLOCK:(b + 1) * BLOCK]
        outs[0].append(np.asarray(jeng.process_block(xb)))
        outs[1].append(teng.process_block(xb))
    assert rel_rms(np.concatenate(outs[1], -1), np.concatenate(outs[0], -1)) <= TOL
    assert teng.eq_runtime.active.definition == tapo.parse(defs[1], "b.txt")

    for S in (2, 1):
        jeng, teng = JEngine(B, SR, BLOCK), TEngine(B, SR, BLOCK, device="cpu")
        assert not teng.spatial_ready
        xb = x[:, :S, :BLOCK]
        got = teng.process_block(xb)
        np.testing.assert_array_equal(got, np.asarray(jeng.process_block(xb)))
        np.testing.assert_array_equal(got, x[:, [0, S - 1], :BLOCK])
    with pytest.raises(ValueError, match="expected"):
        teng.process_block(x[:2, :, :BLOCK])


# --- StreamPool.set_renderer ---------------------------------------------------


def pool_renderers(seed: int, frames: int = 700, lookahead: int = 1):
    """(JAX renderer, port renderer, [S, 2, L] HRIR) from one seeded
    14-channel bank through both packages' asset paths."""
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)
    wav = JWAVData(SR48, audio)
    return (jprepare(wav, jcm.STEREO, SR48, BLOCK, lookahead=lookahead),
            tprepare(TWAVData(SR48, audio), tcm.STEREO, SR48, BLOCK,
                     lookahead=lookahead, device="cpu"),
            build_hrir_time_domain(wav, jcm.STEREO, SR48))


class PoolPair:
    """A JAX pool and the port's (CPU) driven call for call."""

    def __init__(self, max_streams, renderers, M=1, eq=None, **kw):
        self.j = JPool(max_streams, SR48, renderers[0],
                       eq_definition=None if eq is None else japo.parse(eq, "e"),
                       block_size=BLOCK, blocks_per_step=M, **kw)
        self.t = TPool(max_streams, SR48, renderers[1],
                       eq_definition=None if eq is None else tapo.parse(eq, "e"),
                       block_size=BLOCK, blocks_per_step=M, device="cpu", **kw)
        self.step = self.t.step_frames

    def attach(self):
        a = self.j.attach()
        assert self.t.attach() == a
        return a

    def set_renderer(self, renderers, crossfade=True):
        got = self.j.set_renderer(renderers[0], crossfade=crossfade)
        assert self.t.set_renderer(renderers[1], crossfade=crossfade) is got
        return got

    def push(self, s, chunk):
        self.j.push(s, chunk)
        self.t.push(s, chunk)

    def pump(self):
        assert self.j.pump() == self.t.pump()

    def pull(self, s, n):
        a, b = self.j.pull(s, n), self.t.pull(s, n)
        assert rel_rms(b, a) <= TOL, s
        return b


def test_pool_ring_crossfade_ragged_pause():
    """tests/test_hotswap.py:218 on the port: a swap mid-traffic with one
    lane paused across it. Active lanes blend in the swap round, the paused
    lane at its rejoin (after its debt roll), and a lane attached after the
    swap hears the new bank directly."""
    rng = np.random.default_rng(21)
    old, new = pool_renderers(31), pool_renderers(32)
    pair = PoolPair(4, old)
    lanes = [pair.attach() for _ in range(3)]
    sigs = [(rng.standard_normal((2, 12 * BLOCK)) * 0.3).astype(np.float32)
            for _ in range(4)]
    sched = {0: set(range(10)), 1: set(range(10)), 2: {0, 1, 5, 6, 7, 8, 9}}
    fed, late = [0, 0, 0, 0], None
    for it in range(10):
        if it == 4:
            assert pair.set_renderer(new) is True
            assert pair.t.stats()["hotswap_fading"] == 3
        if it == 6:
            late = pair.attach()
        for i, s in enumerate(lanes):
            if it in sched[i]:
                pair.push(s, sigs[i][:, fed[i] * BLOCK:(fed[i] + 1) * BLOCK])
                fed[i] += 1
        if late is not None:
            pair.push(late, sigs[3][:, fed[3] * BLOCK:(fed[3] + 1) * BLOCK])
            fed[3] += 1
        pair.pump()
    starts = {0: 4 * BLOCK, 1: 4 * BLOCK, 2: 2 * BLOCK}
    for i, s in enumerate(lanes):
        y = pair.pull(s, fed[i] * BLOCK)
        ref = lane_ref(sigs[i][:, :fed[i] * BLOCK], old[2], new[2], starts[i],
                       BLOCK)
        assert rel_rms(y, ref) <= TOL, i
    y = pair.pull(late, fed[3] * BLOCK)
    assert rel_rms(y, full_conv(sigs[3][:, :fed[3] * BLOCK], new[2])) <= TOL
    stats = pair.t.stats()
    assert pair.t._xfade_params is None and stats["hotswap_fading"] == 0
    assert stats["fade_rounds"] == 2 and stats["debt_rolls"] > 0


def test_pool_paged_crossfade_with_folded_eq():
    """tests/test_hotswap.py:267 on the port: M=4 with a preamp EQ. The fade
    round bypasses the EQ fold for that one round (the blend drives the
    EQ), then the folded steady state returns."""
    rng = np.random.default_rng(22)
    M, n_rounds, swap_round = 4, 12, 6
    old, new = pool_renderers(33, lookahead=M), pool_renderers(34, lookahead=M)
    pair = PoolPair(2, old, M=M, eq=b"Preamp: -6 dB\n", ring_blocks=64)
    lanes = [pair.attach() for _ in range(2)]
    L = pair.step
    sigs = [(rng.standard_normal((2, n_rounds * L)) * 0.3).astype(np.float32)
            for _ in lanes]
    for it in range(n_rounds):
        if it == swap_round:
            assert pair.set_renderer(new) is True
        for i, s in enumerate(lanes):
            pair.push(s, sigs[i][:, it * L:(it + 1) * L])
        pair.pump()
    gain, fade, cut = 10.0 ** (-6.0 / 20.0), min(960, L), 4 * L
    for i, s in enumerate(lanes):
        y = pair.pull(s, n_rounds * L)
        ref = gain * lane_ref(sigs[i], old[2], new[2], swap_round * L, fade)
        # The pool's initial unity -> preamp ramp (960 samples) is skipped.
        assert rel_rms(y[:, cut:], ref[:, cut:]) <= TOL, i
    assert pair.t._xfade_params is None
    assert pair.t.stats()["fade_rounds"] == 1


@pytest.mark.parametrize("M", [1, 2])
def test_paused_lane_rejoins_after_shorter_bank_swap(M):
    """A crossfaded swap to a bank of fewer partitions pads it onto the
    carry, so the lane-debt modulus stays the carry's: a lane paused across
    the swap for a whole number of the NEW bank's cycles (but not the
    carry's) must still be rolled at rejoin. It rejoins, fades, and matches
    the oracle; a longer bank then resets."""
    rng = np.random.default_rng(40 + M)
    old = pool_renderers(38, frames=700, lookahead=M)
    short = pool_renderers(39, frames=300, lookahead=M)
    pair = PoolPair(2, old, M=M, ring_blocks=64)
    carry_cycle = old[1].partition_count // M
    short_cycle = short[1].partition_count // M
    pause = short_cycle  # repaid by the carry's modulus, not the bank's
    assert pause % carry_cycle
    a, b = pair.attach(), pair.attach()
    L, n = pair.step, 4 + pause + 4
    sigs = [(rng.standard_normal((2, n * L)) * 0.3).astype(np.float32)
            for _ in range(2)]
    fed_b = 0
    for it in range(n):
        if it == 3:
            assert pair.set_renderer(short) is True
        pair.push(a, sigs[0][:, it * L:(it + 1) * L])
        if not 2 <= it < 2 + pause:
            pair.push(b, sigs[1][:, fed_b * L:(fed_b + 1) * L])
            fed_b += 1
        pair.pump()
    assert pair.t._lane_cycle == carry_cycle
    fade = min(960, L)
    y = pair.pull(a, n * L)
    assert rel_rms(y, lane_ref(sigs[0], old[2], short[2], 3 * L, fade)) <= TOL
    y = pair.pull(b, fed_b * L)
    assert rel_rms(y, lane_ref(sigs[1][:, :fed_b * L], old[2], short[2], 2 * L,
                               fade)) <= TOL
    assert pair.t.stats()["debt_rolls"] > 0
    longer = pool_renderers(40, frames=2000, lookahead=M)
    assert pair.set_renderer(longer) is False
    assert pair.t._xfade_params is None
    assert pair.t._lane_cycle == longer[1].partition_count // M
    pair.push(a, np.zeros((2, L), np.float32))
    pair.pump()
    np.testing.assert_array_equal(pair.t.pull(a, L), 0.0)  # history reset
    np.testing.assert_array_equal(pair.j.pull(a, L), 0.0)


def test_pool_second_swap_mid_fade_matches_jax():
    """A second swap while a paused lane still owes the first fade. The
    lane that faded in time (a) blends bank 1 -> bank 2, as both pools
    render it. The paused lane (b) last played bank 0, so at its rejoin
    the port blends it bank 0 -> bank 2 from the three-half fade bank
    [0 | 1 | 2], the ideal trajectory within 1e-5. The JAX pool
    (stream_pool.py:880) blends it from the intermediate bank 1 instead:
    its jump from bank 0 to bank 1 at that round boundary is held here as
    a gap of at least 0.1 rel-RMS from the ideal (0.341 on these inputs)."""
    rng = np.random.default_rng(23)
    r0, r1, r2 = (pool_renderers(s) for s in (51, 52, 53))
    pair = PoolPair(2, r0)
    a, b = pair.attach(), pair.attach()
    n = 8
    sigs = [(rng.standard_normal((2, n * BLOCK)) * 0.3).astype(np.float32)
            for _ in range(2)]
    fed_b = 0
    for it in range(n):
        if it == 2:
            assert pair.set_renderer(r1) is True
        if it == 4:
            assert pair.set_renderer(r2) is True
            assert pair.t.stats()["hotswap_fading"] == 2
            assert pair.t._xfade_params.num_ears == 6  # [0 | 1 | 2]
        pair.push(a, sigs[0][:, it * BLOCK:(it + 1) * BLOCK])
        if not 2 <= it < 5:
            pair.push(b, sigs[1][:, fed_b * BLOCK:(fed_b + 1) * BLOCK])
            fed_b += 1
        pair.pump()
    ya = pair.pull(a, n * BLOCK)
    y01 = lane_ref(sigs[0], r0[2], r1[2], 2 * BLOCK, BLOCK)
    y12 = lane_ref(sigs[0], r1[2], r2[2], 4 * BLOCK, BLOCK)
    ideal = np.concatenate([y01[:, :4 * BLOCK], y12[:, 4 * BLOCK:]], 1)
    assert rel_rms(ya, ideal) <= TOL
    ideal_b = lane_ref(sigs[1][:, :fed_b * BLOCK], r0[2], r2[2], 2 * BLOCK,
                       BLOCK)
    assert rel_rms(pair.t.pull(b, fed_b * BLOCK), ideal_b) <= TOL
    assert rel_rms(pair.j.pull(b, fed_b * BLOCK), ideal_b) >= 0.1
    assert pair.t._xfade_params is None


@pytest.mark.parametrize("M", [1, 2])
def test_prewarm_include_hotswap(M):
    """prewarm(include_hotswap=True) runs the dual-bank rounds on a
    throwaway state: the pool's own audio is unchanged by it, before and
    during a fade, and the swap renders as the JAX pool and the oracle do."""
    rng = np.random.default_rng(25)
    old, new = pool_renderers(41, lookahead=M), pool_renderers(42, lookahead=M)
    pair = PoolPair(2, old, M=M)
    pair.t.prewarm(include_hotswap=True)
    s = pair.attach()
    L = pair.step
    sig = (rng.standard_normal((2, 6 * L)) * 0.3).astype(np.float32)
    for it in range(6):
        if it == 2:
            assert pair.set_renderer(new) is True
            pair.t.prewarm(include_hotswap=True)
        pair.push(s, sig[:, it * L:(it + 1) * L])
        pair.pump()
    y = pair.pull(s, 6 * L)
    assert rel_rms(y, lane_ref(sig, old[2], new[2], 2 * L, min(960, L))) <= TOL
    assert pair.t.stats()["fade_rounds"] == 1


def test_fade_round_runs_one_mac_at_twice_the_columns(monkeypatch):
    """Each fade round is one MAC over the delay line at twice the steady
    columns (O = 8 ring, O = M*8 paged), and the rounds after it go back."""
    seen = []
    mac, pages = tupols.mac_kmajor, tupols.mac_kmajor_pages
    monkeypatch.setattr(tupols, "mac_kmajor",
                        lambda f, h, *a, **k: seen.append(h.shape[1]) or mac(f, h, *a, **k))
    monkeypatch.setattr(tupols, "mac_kmajor_pages",
                        lambda p, b, *a, **k: seen.append(b.shape[2]) or pages(p, b, *a, **k))
    for M in (1, 2):
        old, new = pool_renderers(61, lookahead=M), pool_renderers(62, lookahead=M)
        pool = TPool(2, SR48, old[1], block_size=BLOCK, blocks_per_step=M,
                     device="cpu")
        s = pool.attach()
        del seen[:]
        for it in range(3):
            if it == 1:
                pool.set_renderer(new[1])
            pool.push(s, np.ones((2, pool.step_frames), np.float32))
            pool.pump()
        assert seen == [4 * M, 8 * M, 4 * M], M


RESET_TOL = 1e-6  # the pools' outputs after a reset swap, port vs JAX


def feed_rounds(pools, lanes, sigs, rounds, start):
    """Push round `start`..`start + rounds - 1` of each lane's signal into
    every pool and pump each round."""
    for pool in pools:
        L = pool.step_frames
        for it in range(start, start + rounds):
            for s, sig in zip(lanes, sigs):
                pool.push(s, sig[:, it * L:(it + 1) * L])
            pool.pump()


@pytest.mark.parametrize("M", [1, 2])
def test_pool_reset_swap_matches_jax(M):
    """set_renderer(crossfade=False) onto a same-shape bank zeroes the carry
    in place (each leaf keeps its storage) and the rounds after it render as
    the JAX pool's do, within 1e-6."""
    rng = np.random.default_rng(80 + M)
    old = pool_renderers(81, lookahead=M)
    new = pool_renderers(82, lookahead=M)
    assert new[1].partition_count == old[1].partition_count
    pair = PoolPair(3, old, M=M, ring_blocks=8 * M)
    lanes = [pair.attach() for _ in range(2)]
    L = pair.step
    sigs = [(rng.standard_normal((2, 8 * L)) * 0.3).astype(np.float32)
            for _ in lanes]
    feed_rounds([pair.j, pair.t], lanes, sigs, 4, 0)
    before = [pair.t.pull(s, 4 * L) for s in lanes]
    ptrs = [t.data_ptr() for _, t in _carry_leaves(pair.t._state)]
    assert pair.set_renderer(new, crossfade=False) is False
    assert [t.data_ptr() for _, t in _carry_leaves(pair.t._state)] == ptrs
    conv = pair.t._state.conv
    assert not any(t.any() for t in (conv.pages if M > 1 else (conv.fdl,)))
    feed_rounds([pair.j, pair.t], lanes, sigs, 4, 4)
    for s, sig, head in zip(lanes, sigs, before):
        assert rel_rms(head, pair.j.pull(s, 4 * L)) <= TOL
        y, yj = pair.t.pull(s, 4 * L), pair.j.pull(s, 4 * L)
        assert rel_rms(y, yj) <= RESET_TOL
        # History restarts at the swap: the new bank over the later rounds.
        assert rel_rms(y, full_conv(sig[:, 4 * L:], new[2])) <= TOL


@pytest.mark.parametrize("M,materialize", [(1, False), (2, False), (1, True)])
def test_snapshot_before_a_reset_swap_restores_bit_for_bit(M, materialize):
    """A snapshot taken before a reset swap zeroes the carry in place is a
    copy: restored after the swap (back onto the old bank), the pool renders
    bit for bit as a twin that never swapped."""
    rng = np.random.default_rng(90 + M)
    old = pool_renderers(91, lookahead=M)
    new = pool_renderers(92, lookahead=M)
    pools = [TPool(3, SR48, old[1], block_size=BLOCK, blocks_per_step=M,
                   ring_blocks=8 * M, device="cpu") for _ in range(2)]
    lanes = [pools[0].attach(), pools[0].attach()]
    assert [pools[1].attach() for _ in lanes] == lanes
    L = pools[0].step_frames
    sigs = [(rng.standard_normal((2, 8 * L)) * 0.3).astype(np.float32)
            for _ in lanes]
    feed_rounds(pools, lanes, sigs, 3, 0)
    snap = pools[0].snapshot(materialize=materialize)
    assert pools[0].set_renderer(new[1], crossfade=False) is False
    feed_rounds(pools[:1], lanes, sigs, 1, 3)  # rounds on the zeroed carry
    assert pools[0].set_renderer(old[1], crossfade=False) is False
    pools[0].restore(snap)
    for p in pools:
        for s in lanes:
            p.pull(s, p.available(s))
    feed_rounds(pools, lanes, sigs, 4, 4)
    for s in lanes:
        np.testing.assert_array_equal(pools[0].pull(s, 4 * L),
                                      pools[1].pull(s, 4 * L))


def test_renderer_swap_validation():
    old = pool_renderers(71)
    pool = TPool(2, SR48, old[1], block_size=BLOCK, device="cpu")
    mono = TRendererState(conv_params=old[1].conv_params, speakers=("C",),
                          sample_rate=SR48, block_size=BLOCK)
    with pytest.raises(ValueError, match="speaker count"):
        pool.set_renderer(mono)
    paged = pool_renderers(71, lookahead=2)
    with pytest.raises(ValueError, match="lookahead=2"):
        TPool(2, SR48, paged[1], block_size=BLOCK, blocks_per_step=2,
              device="cpu").set_renderer(old[1])
    moved = interop.renderer_from_numpy(old[0], device="cpu")
    assert pool.set_renderer(moved) is True
