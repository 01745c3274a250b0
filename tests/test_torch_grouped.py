"""Profile-grouped pools of the PyTorch port against the JAX package's, on
the CPU: pool_step_body's grouped round, StreamPool(profiles=...) on both
tiers, per-group EQ retargets and hot-swaps, grouped snapshots, files and
resize, the server's group routing and `serve --profile`.

The port runs on the CPU (its kernels' plain versions) on the same seeded
inputs as the JAX pool; every lane agrees within 1e-5 rel-RMS with the JAX
pool and with the float64 oracle (np.convolve over the lane's whole
history, then the float64 EQ cascade from rest), the time-varying one
across a hot-swap: y = (1 - r) * (h_old * x) + r * (h_new * x), r rising
(i+1)/fade from the lane's fade. Shapes are tests/test_grouped.py's: block
64, at most 16 lanes, 2 to 4 groups whose banks differ in length, so each
group carries its own partition count. The EQ crossfade is shortened to
two blocks, as in the JAX package's randomized grouped test."""

import argparse
import threading

import numpy as np
import pytest
import torch

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.config import AirwaveConfig as JConfig
from airwave_tpu.graph.renderer import build_hrir_time_domain
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io import apo as japo
from airwave_tpu.io import wav as jwav
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.ops import biquad_design as jbd
from airwave_tpu.ops import eq_block as jeq
from airwave_tpu.ops import upols as jupols
from airwave_tpu.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu.runtime import stream_pool as jsp
from airwave_tpu.shell import serve as jserve
from airwave_tpu.shell import wire_client as jwire
from airwave_tpu.utils import checkpoint as jckpt
from airwave_tpu_torch import interop
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.config import AirwaveConfig as TConfig
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.io import wav as twav
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import eq_block as teq
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.runtime import stream_pool as tsp
from airwave_tpu_torch.shell import app as tapp
from airwave_tpu_torch.shell import serve as tserve
from airwave_tpu_torch.shell import wire_client as twire
from airwave_tpu_torch.utils import checkpoint as tckpt
from _torch_sigpipe import sigpipe_ignored  # noqa: F401

SR = 48_000.0
BLOCK = 64
TOL = 1e-5        # port vs JAX, and vs float64
RAMP = 2 * BLOCK  # the shortened EQ crossfade
JCFG = JConfig(crossfade_duration_seconds=RAMP / SR)
TCFG = TConfig(crossfade_duration_seconds=RAMP / SR)
EQ_TEXT = {
    0: None,
    1: b"Preamp: -1.5 dB\nFilter 1: ON PK Fc 700 Hz Gain 2.5 dB Q 1.0\n",
    2: b"Preamp: 2 dB\nFilter 1: ON HSC Fc 6000 Hz Gain -3 dB Q 0.8\n",
    3: b"Preamp: -1 dB\nFilter 1: ON LSC Fc 120 Hz Gain -2.5 dB Q 0.7\n",
}



def rel_rms(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((y - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def eq_def(kind, apo):
    return None if EQ_TEXT[kind] is None else apo.parse(EQ_TEXT[kind], "e.txt")


def full_conv(x: np.ndarray, hrir: np.ndarray) -> np.ndarray:
    """y[e, t] = sum_s (x_s * h[s, e])(t), f64, over the whole history."""
    n = x.shape[-1]
    y = np.zeros((hrir.shape[1], n))
    for s in range(hrir.shape[0]):
        for e in range(hrir.shape[1]):
            y[e] += np.convolve(x[s].astype(np.float64),
                                hrir[s, e].astype(np.float64))[:n]
    return y


def ramp(n: int, start: int, fade: int) -> np.ndarray:
    r = np.zeros(n)
    r[start:] = np.minimum((np.arange(n - start) + 1) / fade, 1.0)
    return r


def lane_ref(x, h_old, h_new, fade_start, fade):
    r = ramp(x.shape[-1], fade_start, fade)
    return (1.0 - r) * full_conv(x, h_old) + r * full_conv(x, h_new)


def with_eq(dry: np.ndarray, kind: int) -> np.ndarray:
    """The float64 EQ cascade of preset `kind` from rest."""
    if EQ_TEXT[kind] is None:
        return dry
    preamp, coeffs = jbd.design_cascade(eq_def(kind, japo), SR)
    left, right = EqCascadeOracle(coeffs, preamp, SR).process(
        dry[0].astype(np.float32), dry[1].astype(np.float32))
    return np.stack([left, right])


class Bank:
    """One seeded 14-channel HRIR bank through both packages' asset paths:
    the JAX renderer, the port's (CPU) and the [S, 2, L] time-domain HRIR."""

    def __init__(self, seed: int, frames: int = 300, lookahead: int = 1,
                 layout: str = "STEREO"):
        rng = np.random.default_rng(seed)
        self.audio = (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)
        jl, tl = getattr(jcm, layout), getattr(tcm, layout)
        wav = JWAVData(SR, self.audio)
        self.j = jprepare(wav, jl, SR, BLOCK, lookahead=lookahead)
        self.t = tprepare(TWAVData(SR, self.audio), tl, SR, BLOCK,
                          lookahead=lookahead, device="cpu")
        self.h = build_hrir_time_domain(wav, jl, SR)


class GPair:
    """A grouped JAX pool and the port's (CPU), driven call for call."""

    def __init__(self, lanes, profiles, M=1, **kw):
        self.j = jsp.StreamPool(
            lanes, SR, block_size=BLOCK, blocks_per_step=M, config=JCFG,
            profiles=[jsp.PoolProfile(b.j, eq_def(k, japo))
                      for b, k in profiles], **kw)
        self.t = tsp.StreamPool(
            lanes, SR, block_size=BLOCK, blocks_per_step=M, config=TCFG,
            device="cpu", profiles=[tsp.PoolProfile(b.t, eq_def(k, tapo))
                                    for b, k in profiles], **kw)
        self.step = self.t.step_frames

    def attach(self, g):
        a = self.j.attach(g)
        assert self.t.attach(g) == a
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
        a, b = self.j.pull(s, n), self.t.pull(s, n)
        if np.any(a):
            assert rel_rms(b, a) <= TOL, s
        else:
            assert not np.any(b), s
        return b

    def set_equalizer(self, kind, group=None):
        self.j.set_equalizer(eq_def(kind, japo), group=group)
        self.t.set_equalizer(eq_def(kind, tapo), group=group)

    def set_renderer(self, bank, group, crossfade=True):
        got = self.j.set_renderer(bank.j, group=group, crossfade=crossfade)
        assert self.t.set_renderer(bank.t, group=group,
                                   crossfade=crossfade) is got
        return got

    def settle(self, lanes):
        """Run the construction-time unity -> target ramp out on silence,
        so what follows starts from zero history at the target."""
        for _ in range(RAMP // self.step + 2):
            for s in lanes:
                self.push(s, np.zeros((2, self.step), np.float32))
            self.pump()
            for s in lanes:
                self.pull(s, self.step)


def banks_for(M, *lengths, seed=10):
    return [Bank(seed + i, frames, lookahead=M)
            for i, frames in enumerate(lengths)]


# --- pool_step_body's grouped round --------------------------------------------


def _step_operands(lengths, M):
    """Per-group (JAX params, port params), EQ params of three presets."""
    rng = np.random.default_rng(7)
    params = []
    for n in lengths:
        h = (rng.standard_normal((2, 2, n)) * 0.4).astype(np.float32)
        h[:, :, 0] += 0.7
        kw = dict(pad_to_pow2=False, lookahead=M)
        params.append((jupols.make_conv_params(h, BLOCK, **kw),
                       tupols.make_conv_params(h, BLOCK, device="cpu", **kw)))
    eqs = []
    for kind in (0, 1, 2):
        jp, jc = jbd.design_cascade(eq_def(kind, japo), SR)
        tp, tc = tbd.design_cascade(eq_def(kind, tapo), SR)
        eqs.append((jeq.make_eq_params(jc, jp, BLOCK, state_dim=32),
                    teq.make_eq_params(tc, tp, BLOCK, state_dim=32,
                                       device="cpu")))
    return params, eqs


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("crossfading", [False, True])
def test_grouped_round_matches_jax_and_per_group_rounds(M, crossfading):
    """tests/test_grouped.py:111 and :160 on the port: pool_step_body with
    G-tuple params and carry (masked ring or paged variant, ragged
    harvests, a partition count per group) equals the JAX grouped round,
    and G ungrouped rounds of the port on the lane segments."""
    G, Bg = (3, 4) if M == 1 else (2, 4)
    B = G * Bg
    lengths = [2 * BLOCK, 4 * BLOCK, 3 * BLOCK][:G]
    params, eqs = _step_operands(lengths, M)
    eq_to, eq_from = eqs[:G], eqs[::-1][:G]
    variant = "ring" if M == 1 else "paged"

    def carry(pkg, g):
        up = jupols if pkg == 0 else tupols
        kw = {} if pkg == 0 else {"device": "cpu"}
        P = params[g][pkg].partition_count
        conv = (up.make_conv_state(Bg, 2, P, BLOCK, **kw) if M == 1
                else up.make_conv_state_paged(Bg, 2, P, BLOCK, M, **kw))
        eqm = jeq if pkg == 0 else teq
        return conv, eqm.make_eq_state(Bg, 2, 32, **kw)

    jstate = jsp.PoolState(*zip(*(carry(0, g) for g in range(G))))
    tstate = tsp.PoolState(*zip(*(carry(1, g) for g in range(G))))
    singles = [tsp.PoolState(*carry(1, g)) for g in range(G)]
    rng = np.random.default_rng(3 + M)
    shape = (B, 2, BLOCK) if M == 1 else (B, 2, M, BLOCK)
    kw = dict(transition_length=4 * BLOCK, eq_enabled=True,
              eq_crossfading=crossfading, variant=variant)
    for t in range(3):
        x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        mask = rng.random(B) < 0.8
        mask[0] |= t == 0
        idx = np.flatnonzero(mask)
        jstate, yj = jsp.pool_step_body(
            tuple(p[0] for p in params), tuple(e[0] for e in eq_from),
            tuple(e[0] for e in eq_to), jstate, x[mask],
            idx.astype(np.int32), **kw)
        tstate, yt = tsp.pool_step_body(
            tuple(p[1] for p in params), tuple(e[1] for e in eq_from),
            tuple(e[1] for e in eq_to), tstate, torch.from_numpy(x[mask]),
            torch.from_numpy(idx), **kw)
        assert rel_rms(yt.numpy(), np.asarray(yj)) <= TOL
        for g in range(G):
            sel = (idx >= g * Bg) & (idx < (g + 1) * Bg)
            if not sel.any():
                continue
            singles[g], ys = tsp.pool_step_body(
                params[g][1], eq_from[g][1], eq_to[g][1], singles[g],
                torch.from_numpy(x[idx[sel]]),
                torch.from_numpy(idx[sel] - g * Bg), **kw)
            torch.testing.assert_close(yt[torch.from_numpy(sel)], ys,
                                       rtol=0, atol=1e-6)
    assert tsp._grouped(tstate.conv) and len(tstate.eq) == G


# --- grouped StreamPool --------------------------------------------------------


def _run(pair, lanes, signal, schedule):
    """Push per the schedule, pump, return each lane's pulled audio."""
    fed = [0] * len(lanes)
    L = pair.step
    for row in schedule:
        for i, s in enumerate(lanes):
            if row[i] and fed[i] < signal.shape[-1] // L:
                pair.push(s, signal[i][:, fed[i] * L:(fed[i] + 1) * L])
                fed[i] += 1
        pair.pump()
    return [pair.pull(s, fed[i] * L) for i, s in enumerate(lanes)], fed


@pytest.mark.parametrize("M", [1, 2])
def test_grouped_pool_ragged_matches_jax_and_oracle(M):
    """tests/test_grouped.py:258 and :336 on the port: G=2 groups of
    different bank lengths, one EQ'd and one unity, ragged pauses that owe
    alignment debt; every lane matches the JAX pool and its own float64
    chain through its group's bank and EQ."""
    b0, b1 = banks_for(M, 300, 700)
    assert b0.t.partition_count != b1.t.partition_count
    pair = GPair(4, [(b0, 1), (b1, 0)], M=M)
    lanes = [pair.attach(g) for g in (0, 0, 1, 1)]
    assert lanes == [0, 1, 2, 3]
    pair.settle(lanes)
    rng = np.random.default_rng(30 + M)
    L = pair.step
    signal = (rng.standard_normal((4, 2, 6 * L)) * 0.4).astype(np.float32)
    schedule = rng.random((12, 4)) < 0.6
    schedule[0] = True
    got, fed = _run(pair, lanes, signal, schedule)
    for i, (bank, kind) in enumerate([(b0, 1), (b0, 1), (b1, 0), (b1, 0)]):
        want = with_eq(full_conv(signal[i][:, :fed[i] * L], bank.h), kind)
        assert rel_rms(got[i], want) <= TOL, i
    assert pair.t.stats()["debt_rolls"] > 0
    assert list(np.unique(pair.t._lane_cycles)) == sorted(
        {b.t.partition_count // M for b in (b0, b1)})


def test_grouped_eq_retarget_crossfades_one_group():
    """tests/test_grouped.py:287 on the port: set_equalizer(group=1) ramps
    only group 1's lanes, set_equalizer(None, group=0) ramps group 0 to
    unity; each group equals an ungrouped port pool of its profile, and
    every lane the JAX pool."""
    b0, b1 = banks_for(1, 300, 300, seed=22)
    pair = GPair(4, [(b0, 1), (b1, 2)])
    refs = [tsp.StreamPool(2, SR, b.t, eq_definition=eq_def(k, tapo),
                           block_size=BLOCK, config=TCFG, device="cpu")
            for b, k in ((b0, 1), (b1, 2))]
    lanes = [pair.attach(g) for g in (0, 0, 1, 1)]
    ref_lanes = [(refs[g], refs[g].attach()) for g in (0, 0, 1, 1)]
    rng = np.random.default_rng(31)
    signal = (rng.standard_normal((4, 2, 8 * BLOCK)) * 0.4).astype(np.float32)
    outs = [[] for _ in range(4)]
    want = [[] for _ in range(4)]
    for rnd in range(8):
        if rnd == 3:
            pair.set_equalizer(3, group=1)
            refs[1].set_equalizer(eq_def(3, tapo))
            assert pair.t.stats()["eq_transitioning"] == [False, False]
        if rnd == 5:
            pair.set_equalizer(0, group=0)
            refs[0].set_equalizer(None)
        sl = np.s_[:, rnd * BLOCK:(rnd + 1) * BLOCK]
        for i, s in enumerate(lanes):
            pair.push(s, signal[i][sl])
            ref_lanes[i][0].push(ref_lanes[i][1], signal[i][sl])
        pair.pump()
        for p in refs:
            p.pump()
        for i, s in enumerate(lanes):
            outs[i].append(pair.pull(s, BLOCK))
            want[i].append(ref_lanes[i][0].pull(ref_lanes[i][1], BLOCK))
    for got, ref in zip(outs, want):
        assert rel_rms(np.concatenate(got, 1), np.concatenate(ref, 1)) <= TOL
    assert pair.t.eq_runtimes[1].active.definition == eq_def(3, tapo)
    assert pair.t.eq_runtimes[0].active.definition is None


def test_grouped_pool_bookkeeping_and_validation():
    """tests/test_grouped.py:366 on the port: every invalid call raises the
    JAX pool's exception type, and the per-group free lists, group_of,
    stats and partition counts follow the JAX pool's."""
    b0, b1, longer = banks_for(1, 128, 128, 320, seed=26)
    surround = Bank(29, 128, layout="SURROUND_5_1")
    cases = [
        (lambda m, b, kw: m.StreamPool(5, SR, block_size=BLOCK, **kw, profiles=[
            m.PoolProfile(b[0]), m.PoolProfile(b[1])]), "divide"),
        (lambda m, b, kw: m.StreamPool(4, SR, b[0], block_size=BLOCK, **kw,
                                       profiles=[m.PoolProfile(b[0])]),
         "not both"),
        (lambda m, b, kw: m.StreamPool(4, SR, block_size=BLOCK, **kw),
         "renderer is "),
        (lambda m, b, kw: m.StreamPool(4, SR, block_size=BLOCK, **kw, profiles=[
            m.PoolProfile(b[0]), m.PoolProfile(b[3])]), "share"),
        (lambda m, b, kw: m.StreamPool(4, SR, block_size=BLOCK, **kw,
                                       profiles=[]), "non-empty"),
    ]
    for call, match in cases:
        errors = []
        for m, pkg, kw in ((jsp, "j", {}), (tsp, "t", {"device": "cpu"})):
            b = [getattr(x, pkg) for x in (b0, b1, longer, surround)]
            with pytest.raises((ValueError, TypeError), match=match) as err:
                call(m, b, kw)
            errors.append(type(err.value))
        assert errors[0] is errors[1], match

    pair = GPair(4, [(b0, 0), (longer, 0)])
    assert pair.t._lane_cycles[0] != pair.t._lane_cycles[-1]
    assert pair.t.groups == 2 and pair.t.group_size == 2
    a, b = pair.attach(0), pair.attach(0)
    assert {pair.t.group_of(a), pair.t.group_of(b)} == {0}
    for pool in (pair.j, pair.t):
        with pytest.raises(RuntimeError, match="group 0 is full"):
            pool.attach(0)
        with pytest.raises(ValueError, match="out of range"):
            pool.attach(2)
    c = pair.attach(1)
    assert pair.t.group_of(c) == 1
    pair.detach(b)
    assert pair.attach(0) == b
    assert pair.t.stats()["attached_per_group"] == [2, 1] == \
        pair.j.stats()["attached_per_group"]
    assert sorted(pair.t._free) == sorted(pair.j._free) == [3]
    for pool, bank in ((pair.j, b0.j), (pair.t, b0.t)):
        with pytest.raises(ValueError, match="group"):
            pool.set_renderer(bank)  # a grouped pool needs group=
        with pytest.raises(ValueError, match="out of range"):
            pool.set_renderer(bank, group=2)
        with pytest.raises(ValueError, match="out of range"):
            pool.set_equalizer(None, group=7)
    with pytest.raises(ValueError, match="speakers, block"):
        pair.t.set_renderer(surround.t, group=1)
    assert pair.set_renderer(longer, 0) is False  # grows group 0's carry
    assert list(pair.t._lane_cycles) == list(pair.j._lane_cycles)
    assert pair.t._lane_cycles[0] == longer.t.partition_count


@pytest.mark.parametrize("M", [1, 2])
def test_grouped_set_renderer_resets_only_that_group(M):
    """tests/test_grouped.py:413 on the port: a crossfade=False swap of
    group 1 to a longer bank restarts group 1's history on a new carry of
    the new partition count; group 0's carry is the same tensor and its
    lane renders on uninterrupted."""
    b0, b1, b1b = banks_for(M, 300, 300, 700, seed=33)
    pair = GPair(4, [(b0, 0), (b1, 0)], M=M)
    s0, s1 = pair.attach(0), pair.attach(1)
    L = pair.step
    rng = np.random.default_rng(36)
    sig = (rng.standard_normal((2, 2, 6 * L)) * 0.4).astype(np.float32)
    for t in range(6):
        if t == 3:
            before = pair.t._conv[0]
            assert pair.set_renderer(b1b, 1, crossfade=False) is False
            assert pair.t._conv[0] is before
            assert pair.t._bank_partitions[1] == b1b.t.partition_count
        pair.push(s0, sig[0][:, t * L:(t + 1) * L])
        pair.push(s1, sig[1][:, t * L:(t + 1) * L])
        pair.pump()
    assert rel_rms(pair.pull(s0, 6 * L), full_conv(sig[0], b0.h)) <= TOL
    y1 = pair.pull(s1, 6 * L)
    assert rel_rms(y1[:, :3 * L], full_conv(sig[1][:, :3 * L], b1.h)) <= TOL
    assert rel_rms(y1[:, 3 * L:], full_conv(sig[1][:, 3 * L:], b1b.h)) <= TOL


@pytest.mark.parametrize("M", [1, 2])
def test_grouped_snapshot_restores_bit_for_bit_across_packages(M):
    """tests/test_grouped.py:459 on the port: a grouped snapshot taken
    mid-retarget restores into a fresh port pool bit for bit; the JAX
    pool's snapshot, moved through interop, restores into the port's pool
    and the continuation matches the JAX pool's; a one-profile pool
    refuses it with the JAX pool's ValueError."""
    b0, b1 = banks_for(M, 300, 700, seed=40)
    pair = GPair(4, [(b0, 1), (b1, 2)], M=M)
    s0, s1 = pair.attach(0), pair.attach(1)
    L = pair.step
    rng = np.random.default_rng(42)
    sig = (rng.standard_normal((2, 2, 5 * L)) * 0.4).astype(np.float32)
    for t in range(3):
        if t == 2:
            pair.set_equalizer(2, group=0)  # in flight at the snapshot
        pair.push(s0, sig[0][:, t * L:(t + 1) * L])
        if t != 1:
            pair.push(s1, sig[1][:, t * L:(t + 1) * L])
        pair.pump()
        pair.pull(s0, L)
        pair.pull(s1, pair.t.available(s1))
    snap = pair.t.snapshot()
    assert len(snap["eq_runtimes"]) == 2 and snap["groups"] == 2
    fresh = tsp.StreamPool(4, SR, block_size=BLOCK, blocks_per_step=M,
                           config=TCFG, device="cpu", profiles=[
                               tsp.PoolProfile(b0.t, eq_def(1, tapo)),
                               tsp.PoolProfile(b1.t, eq_def(2, tapo))])
    fresh.restore(snap)
    moved = tsp.StreamPool(4, SR, block_size=BLOCK, blocks_per_step=M,
                           config=TCFG, device="cpu", profiles=[
                               tsp.PoolProfile(b0.t, eq_def(1, tapo)),
                               tsp.PoolProfile(b1.t, eq_def(2, tapo))])
    moved.restore(interop.pool_snapshot_from_numpy(pair.j.snapshot(),
                                                   device="cpu"))
    for t in range(3, 5):
        for pool in (pair, fresh, moved):
            pool.push(s0, sig[0][:, t * L:(t + 1) * L])
            pool.push(s1, sig[1][:, t * L:(t + 1) * L])
            pool.pump()
    for s in (s0, s1):
        y = pair.pull(s, 2 * L)
        np.testing.assert_array_equal(fresh.pull(s, 2 * L), y)
        assert rel_rms(moved.pull(s, 2 * L), y) <= TOL
    single = tsp.StreamPool(4, SR, b0.t, block_size=BLOCK, blocks_per_step=M,
                            device="cpu")
    with pytest.raises(ValueError, match="profile groups"):
        single.restore(snap)
    with pytest.raises(ValueError, match="profile groups"):
        jsp.StreamPool(4, SR, b0.j, block_size=BLOCK,
                       blocks_per_step=M).restore(pair.j.snapshot())


@pytest.mark.parametrize("M", [1, 2])
def test_grouped_randomized_differential_with_churn(M):
    """tests/test_grouped.py:585 on the port, with its seeds and draws:
    random ragged schedules, detach/attach churn and per-group EQ
    retargets (at all-active stretches, as the round clock of a retarget
    needs); the port's grouped pool matches the JAX grouped pool within
    1e-5 and one ungrouped port pool per group within the JAX test's
    tolerance, sample for sample."""
    G, Bg = 2, 2
    for seed in (101, 202):
        rng = np.random.default_rng(seed)
        r0, r1 = banks_for(M, 2 * BLOCK, 5 * BLOCK, seed=seed)
        assert r0.t.partition_count != r1.t.partition_count
        pair = GPair(G * Bg, [(r0, 1), (r1, 2)], M=M)
        refs = [tsp.StreamPool(Bg, SR, b.t, eq_definition=eq_def(k, tapo),
                               block_size=BLOCK, config=TCFG,
                               blocks_per_step=M, device="cpu")
                for b, k in ((r0, 1), (r1, 2))]
        glanes = [[None] * Bg for _ in range(G)]
        rlanes = [[None] * Bg for _ in range(G)]

        def attach(g, i):
            glanes[g][i] = pair.attach(g)
            rlanes[g][i] = refs[g].attach()

        for g in range(G):
            for i in range(Bg):
                attach(g, i)
        ramp_guard = 0
        step = pair.step
        for _ in range(40):
            if ramp_guard == 0 and rng.random() < 0.15:
                tg, kind = int(rng.integers(0, G)), int(rng.integers(0, 3))
                pair.set_equalizer(kind, group=tg)
                refs[tg].set_equalizer(eq_def(kind, tapo))
                ramp_guard = 4
            active = (rng.random((G, Bg)) < 0.7) | (ramp_guard > 0)
            ramp_guard = max(0, ramp_guard - 1)
            for g in range(G):
                for i in range(Bg):
                    if glanes[g][i] is None:
                        if rng.random() < 0.3:
                            attach(g, i)
                        continue
                    if ramp_guard == 0 and rng.random() < 0.05:
                        pair.detach(glanes[g][i])
                        refs[g].detach(rlanes[g][i])
                        glanes[g][i] = None
                        continue
                    if active[g, i]:
                        chunk = (rng.standard_normal((2, step)) * 0.4
                                 ).astype(np.float32)
                        pair.push(glanes[g][i], chunk)
                        refs[g].push(rlanes[g][i], chunk)
            pair.pump()
            for p in refs:
                p.pump()
            for g in range(G):
                for i in range(Bg):
                    if glanes[g][i] is None:
                        continue
                    n = pair.t.available(glanes[g][i])
                    assert n == refs[g].available(rlanes[g][i])
                    if n:
                        np.testing.assert_allclose(
                            pair.pull(glanes[g][i], n),
                            refs[g].pull(rlanes[g][i], n),
                            rtol=1e-4, atol=5e-5)
        assert pair.t.render_errors == 0


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_grouped_checkpoint_file_across_packages(tmp_path, writer, M):
    """tests/test_grouped.py:678 on the port, both directions: a grouped
    checkpoint file (a lane in debt, a retarget in flight) written by one
    package restores the other's pool with every carry leaf bit for bit
    the writer's, the header the JAX package writes, and the continuation
    within 1e-5 of the writer's; a pool of another construction refuses it
    with a SnapshotCompatError (a ValueError)."""
    b0, b1 = banks_for(M, 300, 700, seed=70)
    pair = GPair(4, [(b0, 1), (b1, 2)], M=M)
    s0, s1 = pair.attach(0), pair.attach(1)
    L = pair.step
    rng = np.random.default_rng(72)
    sig = (rng.standard_normal((2, 2, 6 * L)) * 0.4).astype(np.float32)
    for t in range(3):
        if t == 2:
            pair.set_equalizer(0, group=1)  # in flight at the snapshot
        pair.push(s0, sig[0][:, t * L:(t + 1) * L])
        if t != 1:
            pair.push(s1, sig[1][:, t * L:(t + 1) * L])
        pair.pump()
    for s in (s0, s1):
        pair.pull(s, pair.t.available(s))
    path = str(tmp_path / "grouped")
    src, dst = (pair.t, pair.j) if writer == "port" else (pair.j, pair.t)
    (tckpt if writer == "port" else jckpt).save_pool_snapshot(path,
                                                              src.snapshot())
    other = tckpt if writer == "jax" else jckpt
    if writer == "port":
        jpath = str(tmp_path / "jax_header")
        jckpt.save_pool_snapshot(jpath, pair.j.snapshot())
        with tckpt._RawReader(tckpt.checkpoint_path(path)) as t, \
                tckpt._RawReader(tckpt.checkpoint_path(jpath)) as j:
            assert t.treedef_repr == j.treedef_repr
            assert t.extra["carry"] == j.extra["carry"]
            assert [(m["shape"], m["dtype"]) for m in t.leaves] == \
                [(m["shape"], m["dtype"]) for m in j.leaves]
    want = [np.asarray(leaf) for leaf in tckpt._leaves(
        interop.pool_state_to_numpy(src.snapshot()["state"])
        if writer == "port" else src.snapshot()["state"])]
    dst.restore(other.load_pool_snapshot(path, dst))
    got = [np.asarray(leaf) for leaf in tckpt._leaves(
        interop.pool_state_to_numpy(dst.snapshot()["state"])
        if writer == "jax" else dst.snapshot()["state"])]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # The reader continues from the file, the writer from its own state.
    for t in range(3, 6):
        pair.push(s0, sig[0][:, t * L:(t + 1) * L])
        pair.push(s1, sig[1][:, t * L:(t + 1) * L])
        pair.pump()
    for s in (s0, s1):
        pair.pull(s, 3 * L)
    reader_pool = tsp.StreamPool if writer == "jax" else jsp.StreamPool
    kw = {"device": "cpu"} if writer == "jax" else {}
    prof = tsp.PoolProfile if writer == "jax" else jsp.PoolProfile
    pkg = "t" if writer == "jax" else "j"
    mismatch = reader_pool(4, SR, block_size=BLOCK, blocks_per_step=M, **kw,
                           profiles=[prof(getattr(b1, pkg)),
                                     prof(getattr(b1, pkg))])
    with pytest.raises(ValueError):
        other.load_pool_snapshot(path, mismatch)


def test_grouped_push_many_maps_layout_channels():
    """tests/test_grouped.py:730 on the port: full 7.1.4 layout rows map
    through each stream's own group's renderer in one gather, equal to
    per-stream push and to the JAX pool; a channel count that fits no
    group raises ValueError."""
    b0 = Bank(80, 128, layout="ATMOS_7_1_4")
    b1 = Bank(81, 128, layout="ATMOS_7_1_4")
    pair = GPair(4, [(b0, 0), (b1, 0)])
    single = tsp.StreamPool(4, SR, block_size=BLOCK, device="cpu", profiles=[
        tsp.PoolProfile(b0.t), tsp.PoolProfile(b1.t)])
    lanes = [pair.attach(0), pair.attach(1)]
    for g in (0, 1):
        single.attach(g)
    rng = np.random.default_rng(82)
    chunks = (rng.standard_normal((2, 12, 2 * BLOCK)) * 0.3).astype(np.float32)
    pair.j.push_many(lanes, chunks)
    pair.t.push_many(lanes, chunks)
    for lane, chunk in zip(lanes, chunks):
        single.push(lane, chunk)
    pair.pump()
    single.pump()
    for lane in lanes:
        np.testing.assert_array_equal(pair.pull(lane, 2 * BLOCK),
                                      single.pull(lane, 2 * BLOCK))
    for pool in (pair.j, pair.t):
        with pytest.raises(ValueError, match="neither"):
            pool.push_many(lanes, np.zeros((2, 5, BLOCK), np.float32))


# --- grouped hot-swaps ---------------------------------------------------------


@pytest.mark.parametrize("M", [1, 2])
def test_grouped_crossfade_swaps_one_group_only(M):
    """tests/test_hotswap.py:302 on the port: group 1 hot-swaps and fades;
    group 0's lane renders its own bank untouched; both against the JAX
    pool and float64."""
    b_a, b_b, b_b2 = banks_for(M, 700, 700, 700, seed=35)
    pair = GPair(4, [(b_a, 0), (b_b, 0)], M=M)
    s0, s1 = pair.attach(0), pair.attach(1)
    L = pair.step
    rng = np.random.default_rng(23)
    sigs = (rng.standard_normal((2, 2, 8 * L)) * 0.3).astype(np.float32)
    for it in range(8):
        if it == 3:
            assert pair.set_renderer(b_b2, 1) is True
            assert pair.t.stats()["hotswap_fading"] == 1
            assert set(pair.t._xfade_params) == {1}
        pair.push(s0, sigs[0][:, it * L:(it + 1) * L])
        pair.push(s1, sigs[1][:, it * L:(it + 1) * L])
        pair.pump()
    assert rel_rms(pair.pull(s0, 8 * L), full_conv(sigs[0], b_a.h)) <= TOL
    assert rel_rms(pair.pull(s1, 8 * L),
                   lane_ref(sigs[1], b_b.h, b_b2.h, 3 * L, L)) <= TOL
    assert pair.t._xfade_params is None and pair.t.fade_rounds == 1


@pytest.mark.parametrize("M", [1, 2])
def test_grouped_concurrent_swaps_land_in_one_round(M, monkeypatch):
    """tests/test_hotswap.py:330 on the port: both groups' swaps pending
    in the same round, after prewarm(include_hotswap=True); the round runs
    one MAC launch per group over its own delay line at twice the steady
    columns, and both lanes follow the JAX pool and the float64
    time-varying reference."""
    b_a, b_b, b_a2, b_b2 = banks_for(M, 700, 300, 700, 300, seed=43)
    pair = GPair(4, [(b_a, 0), (b_b, 0)], M=M)
    pair.t.prewarm(include_hotswap=True)
    s0, s1 = pair.attach(0), pair.attach(1)
    L = pair.step
    seen = []
    mac, pages = tupols.mac_kmajor, tupols.mac_kmajor_pages
    monkeypatch.setattr(tupols, "mac_kmajor", lambda f, h, *a, **k: seen.append(
        (f.shape[-1], f.shape[1], h.shape[1])) or mac(f, h, *a, **k))
    monkeypatch.setattr(tupols, "mac_kmajor_pages", lambda p, b, *a, **k: seen.append(
        (p[0].shape[-1], len(p), b.shape[2])) or pages(p, b, *a, **k))
    rng = np.random.default_rng(29)
    sigs = (rng.standard_normal((2, 2, 6 * L)) * 0.3).astype(np.float32)
    per_round = []
    for it in range(6):
        if it == 3:
            assert pair.set_renderer(b_a2, 0) is True
            assert pair.set_renderer(b_b2, 1) is True
            assert pair.t.stats()["hotswap_fading"] == 2
        pair.push(s0, sigs[0][:, it * L:(it + 1) * L])
        pair.push(s1, sigs[1][:, it * L:(it + 1) * L])
        del seen[:]
        pair.pump()
        per_round.append(list(seen))
    assert rel_rms(pair.pull(s0, 6 * L),
                   lane_ref(sigs[0], b_a.h, b_a2.h, 3 * L, L)) <= TOL
    assert rel_rms(pair.pull(s1, 6 * L),
                   lane_ref(sigs[1], b_b.h, b_b2.h, 3 * L, L)) <= TOL
    steady_cols, fade_cols = 4 * M, 8 * M
    sizes = [b.t.partition_count * (2 if M == 1 else 1) for b in (b_a, b_b)]
    for it, launches in enumerate(per_round):
        cols = fade_cols if it == 3 else steady_cols
        assert [(lanes, cols) for lanes, _, cols in launches] == \
            [(2, cols), (2, cols)], it
        if M == 1:  # R = S * P2 * 2 differs per group
            assert [r for _, r, _ in launches] == [2 * s for s in sizes]
        else:       # one page pointer per page of the group's line
            assert [n for _, n, _ in launches] == [
                b.t.partition_count // M for b in (b_a, b_b)]
    assert pair.t._xfade_params is None


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("grouped", [False, True])
def test_second_swap_mid_fade_follows_float64(M, grouped):
    """The repaired second swap during a pending fade, on both tiers, one
    profile and grouped: lane a fades bank 0 -> 1 in time, lane b is paused
    across both swaps. After the second swap the fade bank holds three
    halves [0 | 1 | 2] (O = 12 ring, M*12 paged) and each lane blends from
    the bank it last played: a 1 -> 2, b 0 -> 2 at its rejoin, the float64
    time-varying reference within 1e-5. On a grouped pool the other
    group's lane renders its own bank throughout."""
    r0, r1, r2, other = banks_for(M, 700, 700, 700, 300, seed=51)
    G = 2 if grouped else 1
    profiles = [(r0, 0)] + ([(other, 0)] if grouped else [])
    pool = tsp.StreamPool(2 * G, SR, block_size=BLOCK, blocks_per_step=M,
                          device="cpu", config=TCFG, profiles=[
                              tsp.PoolProfile(b.t) for b, _ in profiles])
    g = 0
    a, b = pool.attach(g), pool.attach(g)
    c = pool.attach(1) if grouped else None
    L = pool.step_frames
    n = 8
    rng = np.random.default_rng(23)
    sigs = (rng.standard_normal((3, 2, n * L)) * 0.3).astype(np.float32)
    fed_b = 0
    cols = []
    for it in range(n):
        if it == 2:
            assert pool.set_renderer(r1.t, group=g) is True
        if it == 4:
            assert pool.set_renderer(r2.t, group=g) is True
            assert pool._fades[g].params.num_ears == 6
            cols.append(tupols.single_block_bank(
                pool._fades[g].params, 72).shape[1] if M == 1 else
                tupols.paged_bank(pool._fades[g].params, M, 72).shape[2])
        pool.push(a, sigs[0][:, it * L:(it + 1) * L])
        if not 2 <= it < 5:
            pool.push(b, sigs[1][:, fed_b * L:(fed_b + 1) * L])
            fed_b += 1
        if grouped:
            pool.push(c, sigs[2][:, it * L:(it + 1) * L])
        pool.pump()
    assert cols == [12 * M]
    ya = pool.pull(a, n * L)
    y01 = lane_ref(sigs[0], r0.h, r1.h, 2 * L, L)
    y12 = lane_ref(sigs[0], r1.h, r2.h, 4 * L, L)
    assert rel_rms(ya, np.concatenate([y01[:, :4 * L], y12[:, 4 * L:]], 1)) <= TOL
    yb = pool.pull(b, fed_b * L)
    assert rel_rms(yb, lane_ref(sigs[1][:, :fed_b * L], r0.h, r2.h, 2 * L,
                                L)) <= TOL
    if grouped:
        assert rel_rms(pool.pull(c, n * L), full_conv(sigs[2], other.h)) <= TOL
    assert pool._xfade_params is None and not pool._fades


def test_fade_bank_halves_and_blend_against_plain():
    """The multi-half fade bank is the halves stacked on the ear axis, so
    one MAC gives every half's output; xfade_blend with per-lane `src`
    equals the plain per-lane selection; a ring MAC whose h[k] exceeds the
    kernel's shared memory is split into column runs (the plain version
    here), equal to one contraction."""
    rng = np.random.default_rng(4)
    banks = [tupols.make_conv_params(
        rng.standard_normal((2, 2, 300)).astype(np.float32), BLOCK,
        pad_to_pow2=False, device="cpu") for _ in range(3)]
    fade = tupols.xfade_conv_params(banks[:2], banks[2])
    assert fade.num_ears == 6
    for i, b in enumerate(banks):
        torch.testing.assert_close(fade.Gflip2[:, 2 * i:2 * i + 2], b.Gflip2,
                                   rtol=0, atol=0)
    assert tupols.xfade_conv_params(banks[0], banks[2]).num_ears == 4
    y3 = torch.from_numpy(rng.standard_normal((5, 6, BLOCK)).astype(np.float32))
    r = torch.from_numpy(tupols.xfade_ramp(40, BLOCK))
    src = torch.tensor([0, 1, 1, 0, 1])
    mask = torch.tensor([True, True, False, True, True])
    got = tupols.xfade_blend(y3, r, mask, src, halves=3)
    for lane in range(5):
        old = y3[lane, 2 * int(src[lane]):2 * int(src[lane]) + 2]
        new = y3[lane, 4:]
        want = old * (1 - r) + new * r if mask[lane] else new
        torch.testing.assert_close(got[lane], want, rtol=0, atol=0)
    # The two-half path is the one-profile dual blend, bit for bit.
    y2 = y3[:, 2:]
    torch.testing.assert_close(
        tupols.xfade_blend(y2, r, mask, torch.zeros(5, dtype=torch.int64)),
        tupols.xfade_blend(y2, r, mask), rtol=0, atol=0)
    assert tsp.mac_kmajor.max_columns(238) == 51


def test_self_fade_built_once_per_group_per_swap(monkeypatch):
    """A fade round runs the groups that are not swapping on their
    self-crossfade. Those banks are built once per group and kept across
    the swap's fade rounds (the JAX pool rebuilds them every fade round,
    stream_pool.py:1551); set_renderer of a group drops that group's cached
    bank only, and _rebuild_conv_params drops every group's."""
    banks = banks_for(1, 300, 700, 300, 700, seed=90)
    pool = tsp.StreamPool(6, SR, block_size=BLOCK, config=TCFG, device="cpu",
                          profiles=[tsp.PoolProfile(b.t) for b in banks[:3]])
    lanes = [pool.attach(g) for g in range(3)]
    late = pool.attach(1)
    built = []
    real = tupols.xfade_conv_params
    monkeypatch.setattr(tupols, "xfade_conv_params", lambda o, n: built.append(
        o is n) or real(o, n))
    pool.set_renderer(banks[3].t, group=1)  # lane `late` fades later
    assert built == [False]
    for it in range(4):
        for s in lanes + ([late] if it >= 2 else []):
            pool.push(s, np.ones((2, BLOCK), np.float32) * 0.1)
        pool.pump()
    assert pool.fade_rounds == 2
    assert built == [False, True, True]  # groups 0 and 2, once each
    kept = pool._banks[2].self_fade
    pool.set_renderer(banks[1].t, group=0)
    assert pool._banks[0].self_fade is None
    assert pool._banks[2].self_fade is kept
    pool._rebuild_conv_params()
    assert all(b.self_fade is None for b in pool._banks)


# --- resize ----------------------------------------------------------------------


def test_resize_grouped_compacts_per_group():
    """tests/test_resize.py:162 on the port: each group's attached lanes
    compact into its own new segment (groups of different bank lengths),
    with the JAX pool's lane map; the continuation is the uninterrupted
    pool's within 1e-6 (not bit for bit on the CPU: the plain version's
    einsum tiles its contraction by the lane count, where the kernel
    computes each lane alone) and the JAX pool's within 1e-5; a group that
    overflows its resized segment raises ValueError naming it even when
    the total fits."""
    b0, b1 = banks_for(1, 300, 500, seed=1)
    a = GPair(8, [(b0, 1), (b1, 0)])
    g0, g1 = [a.attach(0)], [a.attach(1), a.attach(1)]
    rng = np.random.default_rng(11)
    sigs = {s: (rng.standard_normal((2, 6 * BLOCK)) * 0.3).astype(np.float32)
            for s in g0 + g1}
    for i in range(3):
        for s in g0 + g1:
            a.push(s, sigs[s][:, i * BLOCK:(i + 1) * BLOCK])
        a.pump()
    for s in g0 + g1:
        a.pull(s, 3 * BLOCK)
    b = GPair(12, [(b0, 1), (b1, 0)])
    lane_map = b.t.restore(a.t.snapshot(), resize=True)
    assert lane_map == b.j.restore(a.j.snapshot(), resize=True)
    assert all(b.t.group_of(lane_map[s]) == 0 for s in g0)
    assert all(b.t.group_of(lane_map[s]) == 1 for s in g1)
    like = b.t.state_like(8)
    assert [tuple(c.fdl.shape) for c in like["state"].conv] == [
        tuple(c.fdl.shape[:-1]) + (4,) for c in b.t._state.conv]
    for pool, id_of in ((a, lambda s: s), (b, lambda s: lane_map[s])):
        for i in range(3, 6):
            for s in g0 + g1:
                pool.push(id_of(s), sigs[s][:, i * BLOCK:(i + 1) * BLOCK])
            pool.pump()
    for s in g0 + g1:
        assert rel_rms(b.pull(lane_map[s], 3 * BLOCK),
                       a.pull(s, 3 * BLOCK)) <= 1e-6
    tiny = tsp.StreamPool(2, SR, block_size=BLOCK, device="cpu", profiles=[
        tsp.PoolProfile(b0.t, eq_def(1, tapo)), tsp.PoolProfile(b1.t)])
    with pytest.raises(ValueError, match="group 1"):
        tiny.restore(a.t.snapshot(), resize=True)
    with pytest.raises(ValueError, match="divide"):
        tiny.state_like(3)


# --- serving ---------------------------------------------------------------------


def _render(address, x, group, chunk=97):
    return twire.render_via_server(address, x, chunk=chunk, group=group)


def test_grouped_server_routes_clients_to_their_profiles():
    """tests/test_serve.py:677 on the port: concurrent clients in two
    groups each render their group's bank (float64, and the JAX grouped
    server on the same input); a group the pool lacks is a protocol error
    that leaves the server up; per-group renderer swaps and EQ retargets
    go through the server's lock."""
    b0, b1 = banks_for(1, 300, 500, seed=7)
    pool = tsp.StreamPool(8, SR, block_size=BLOCK, device="cpu", profiles=[
        tsp.PoolProfile(b0.t), tsp.PoolProfile(b1.t)])
    jpool = jsp.StreamPool(8, SR, block_size=BLOCK, profiles=[
        jsp.PoolProfile(b0.j), jsp.PoolProfile(b1.j)])
    srv = tserve.RenderServer(pool, port=0)
    jsrv = jserve.RenderServer(jpool, port=0)
    srv.start()
    jsrv.start()
    try:
        n = 5 * BLOCK
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((4, 2, n)) * 0.3).astype(np.float32)
        groups = [0, 1, 0, 1]
        got = [None] * 4
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, _render(srv.address, x[i], groups[i]))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i in range(4):
            bank = (b0, b1)[groups[i]]
            assert rel_rms(got[i], full_conv(x[i], bank.h)) <= TOL
            want = jwire.render_via_server(jsrv.address, x[i], chunk=97,
                                           group=groups[i])
            assert rel_rms(got[i], want) <= TOL
        errors = srv.protocol_errors
        import socket
        conn = socket.create_connection(srv.address, timeout=10)
        conn.sendall(b'{"channels": 2, "group": 9}\n')
        assert conn.recv(16) in (b"\x00\x00\x00\x00", b"")
        conn.close()
        assert srv.protocol_errors == errors + 1
        srv.set_renderer(b0.t, group=1)
        srv.set_equalizer(eq_def(1, tapo), group=0)
        assert pool.renderers[1] is b0.t
        y = _render(srv.address, x[1], 1)
        assert rel_rms(y, full_conv(x[1], b0.h)) <= TOL
        assert srv.pump_errors == 0 and pool.render_errors == 0
    finally:
        srv.stop()
        jsrv.stop()


def test_grouped_server_eq_groups_match_single_profile_sequentially():
    """tests/test_serve.py:742 on the port: one client at a time, a
    grouped server's EQ'd group matches a one-profile EQ server of the
    port and of the JAX package, and its unity group the EQ-less float64
    render."""
    (bank,) = banks_for(1, 300, seed=8)
    grouped = tsp.StreamPool(8, SR, block_size=BLOCK, device="cpu", profiles=[
        tsp.PoolProfile(bank.t, None), tsp.PoolProfile(bank.t, eq_def(1, tapo))])
    single = tsp.StreamPool(4, SR, bank.t, eq_definition=eq_def(1, tapo),
                            block_size=BLOCK, device="cpu")
    jsingle = jsp.StreamPool(4, SR, bank.j, eq_definition=eq_def(1, japo),
                             block_size=BLOCK)
    servers = [tserve.RenderServer(p, port=0) for p in (grouped, single)]
    servers.append(jserve.RenderServer(jsingle, port=0))
    for s in servers:
        s.start()
    try:
        rng = np.random.default_rng(8)
        x = (rng.standard_normal((2, 4 * BLOCK)) * 0.3).astype(np.float32)
        got1 = _render(servers[0].address, x, 1, chunk=BLOCK)
        assert rel_rms(got1, _render(servers[1].address, x, 0,
                                     chunk=BLOCK)) <= TOL
        assert rel_rms(got1, jwire.render_via_server(
            servers[2].address, x, chunk=BLOCK)) <= TOL
        got0 = _render(servers[0].address, x, 0, chunk=BLOCK)
        assert rel_rms(got0, full_conv(x, bank.h)) <= TOL
        assert np.sqrt(np.mean((got1 - got0) ** 2)) > 1e-3
    finally:
        for s in servers:
            s.stop()


def _serve_args(tmp_path, **kw):
    rng = np.random.default_rng(9)
    paths = []
    for i, frames in enumerate((600, 1500)):
        path = str(tmp_path / f"bank{i}.wav")
        twav.save(path, (rng.standard_normal((14, frames)) * 0.2
                         ).astype(np.float32), SR)
        paths.append(path)
    eq = tmp_path / "eq.txt"
    eq.write_bytes(EQ_TEXT[1])
    args = dict(hrir=None, eq=None, profile=[
        f"{paths[0]}:{eq}", paths[1], f"{paths[0]}"], layout="stereo",
        sample_rate=SR, max_streams=6, blocks_per_step=1, mesh_devices=0,
        cpu=True, device="cpu")
    args.update(kw)
    return argparse.Namespace(**args)


def test_serve_profile_builds_grouped_pool_and_serves(tmp_path, monkeypatch):
    """`serve --profile` in process: three --profile specs (two share an
    HRIR, which is loaded and prepared once) build a grouped pool with its
    groups' own partition counts and EQs, as the JAX CLI builds it; a
    client of each group renders through the server like the JAX server's
    group; --profile beside --hrir exits."""
    args = _serve_args(tmp_path)
    loads = []
    real = twav.load
    monkeypatch.setattr(twav, "load", lambda p: (
        isinstance(p, str) and loads.append(p)) or real(p))
    pool, layout = tapp.build_serve_pool(args)
    assert len(loads) == 2 and pool.groups == 3 and layout.name == "Stereo"
    # The JAX pool of the same profiles, built as its CLI builds it (its
    # prewarm of every harvest bucket left out).
    jprofiles = []
    for spec in args.profile:
        path, _, eq_path = spec.partition(":")
        definition = (japo.parse(open(eq_path, "rb").read(), "eq.txt")
                      if eq_path else None)
        jprofiles.append(jsp.PoolProfile(
            jprepare(jwav.load(path), jcm.STEREO, SR), definition))
    jpool = jsp.StreamPool(6, SR, profiles=jprofiles)
    assert [r.partition_count for r in pool.renderers] == \
        [r.partition_count for r in jpool.renderers]
    assert pool.renderers[0] is pool.renderers[2]
    srv, jsrv = (tserve.RenderServer(pool, port=0),
                 jserve.RenderServer(jpool, port=0))
    srv.start()
    jsrv.start()
    try:
        x = (np.random.default_rng(3).standard_normal((2, 3 * 512)) * 0.3
             ).astype(np.float32)
        for group in range(3):
            got = _render(srv.address, x, group, chunk=512)
            want = jwire.render_via_server(jsrv.address, x, chunk=512,
                                           group=group)
            assert rel_rms(got, want) <= TOL, group
        assert [rt.active.definition is not None
                for rt in pool.eq_runtimes] == [True, False, False]
    finally:
        srv.stop()
        jsrv.stop()
    with pytest.raises(SystemExit, match="not both"):
        tapp.build_serve_pool(_serve_args(tmp_path, hrir="x.wav"))
    parsed = tapp.build_parser().parse_args(
        ["serve", "--profile", "a.wav:e.txt", "--profile", "b.wav", "--cpu"])
    assert parsed.profile == ["a.wav:e.txt", "b.wav"]


def test_treedef_string_matches_jax_for_every_carry_shape():
    """The checkpoint header's treedef string is JAX's for the trees a
    snapshot holds: grouped carries of both tiers, and a paged carry of one
    page (a 1-tuple, which JAX renders "(*,)")."""
    import jax

    for conv in (tupols.PagedConvState(pages=(np.zeros(1),)),
                 (tupols.PagedConvState(pages=(np.zeros(1), np.zeros(1))),) * 2,
                 (tupols.ConvState(fdl=np.zeros(1),
                                   write_pos=np.zeros((), np.int32)),) * 3):
        eq = teq.EqState(*(np.zeros(1),) * 3)
        tree = {"debt": np.zeros(1), "state": tsp.PoolState(
            conv, (eq,) * len(conv) if type(conv) is tuple else eq)}
        assert tckpt._treedef_repr(tree) == str(
            jax.tree_util.tree_structure(tree))
