"""parallel/mesh, parallel/multihost and the sharded StreamPool of the
PyTorch port against the JAX package. The JAX side runs on the 8 virtual
CPU devices of tests/conftest.py; the port on 8 virtual shards of the CPU
(a mesh whose devices repeat). The same seeded inputs go through both and
the outputs agree within 1e-5 (the JAX tests' own tolerance): the seven
cases of tests/test_parallel.py (the two-process run on gloo), the 7.1.4
speaker-sharded step and the sharded ring and paged pools of
tests/test_native_and_pool.py, the grouped pool over a mesh of
tests/test_grouped.py, snapshots moved between sharded and unsharded pools
of both packages, and `serve --mesh-devices`."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io import apo as japo
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.models import bake as jbake
from airwave_tpu.models.binaural import ChainState as JChainState
from airwave_tpu.models.binaural import chain_step as jchain_step
from airwave_tpu.ops import biquad_design as jbd
from airwave_tpu.ops import eq_block as jeq
from airwave_tpu.ops import upols as jupols
from airwave_tpu.parallel import mesh as jmesh
from airwave_tpu.runtime.stream_pool import PoolProfile as JProfile
from airwave_tpu.runtime.stream_pool import StreamPool as JPool
from airwave_tpu_torch import interop
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.io import wav as twav
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.models.binaural import ChainState as TChainState
from airwave_tpu_torch.models.binaural import chain_step_fn as tchain_step
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import eq_block as teq
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.parallel import mesh as tmesh
from airwave_tpu_torch.parallel import multihost as tmh
from airwave_tpu_torch.runtime.stream_pool import PoolProfile as TProfile
from airwave_tpu_torch.runtime.stream_pool import StreamPool as TPool
from airwave_tpu_torch.shell.app import main as tmain

from _torch_sigpipe import sigpipe_ignored  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000.0
TOL = 1e-5
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)),
                                                  1e-30)


def _build(batch, S=2, T=64, L=200):
    """tests/test_parallel.py's problem, for both packages: (JAX conv, eq,
    state, port conv, eq, state, x, hrir)."""
    rng = np.random.default_rng(0)
    hrir = rng.standard_normal((S, 2, L)).astype(np.float32) * 0.2
    x = rng.standard_normal((batch, S, T)).astype(np.float32)
    jc = jupols.make_conv_params(hrir, T)
    je = jeq.unity_eq_params(T, 16)
    js = JChainState(conv=jupols.make_conv_state(batch, S,
                                                 jc.partition_count, T),
                     eq=jeq.make_eq_state(batch, 2, 16))
    tc = tupols.make_conv_params(hrir, T, device="cpu")
    te = teq.unity_eq_params(T, 16, device="cpu")
    ts = TChainState(conv=tupols.make_conv_state(batch, S,
                                                 tc.partition_count, T, "cpu"),
                     eq=teq.make_eq_state(batch, 2, 16, "cpu"))
    return jc, je, js, tc, te, ts, x, hrir


def _no_collectives(monkeypatch):
    """Make every torch.distributed collective raise: the stream-sharded
    steady state must run none (the JAX test's 'no all-reduce in the
    HLO')."""
    def boom(*args, **kwargs):
        raise AssertionError("a collective ran in a stream-sharded step")
    for name in ("all_reduce", "all_gather", "broadcast", "reduce_scatter",
                 "all_to_all", "all_gather_object"):
        monkeypatch.setattr(torch.distributed, name, boom)


def test_stream_sharded_step_matches_single_device(devices, monkeypatch):
    B, T = 16, 64
    jc, je, js, tc, te, ts, x, _ = _build(B, T=T)
    _, ref_y = jchain_step(jc, je, je, js, x, transition_length=960,
                           spatial_enabled=True, eq_enabled=True)
    jm = jmesh.make_mesh(devices, ("streams",))
    jstate = jmesh.shard_chain_state(_build(B, T=T)[2], jm)
    _, jy = jmesh.stream_sharded_step(jm, transition_length=960)(
        jc, je, je, jstate, x)

    _no_collectives(monkeypatch)
    m = tmesh.make_mesh(CPU8)
    state = tmesh.shard_chain_state(ts, m)
    step = tmesh.stream_sharded_step(m, transition_length=960)
    new_state, y = step(tc, te, te, state, torch.from_numpy(x))
    np.testing.assert_allclose(y.gather().numpy(), np.asarray(ref_y),
                               atol=TOL)
    np.testing.assert_allclose(y.gather().numpy(), np.asarray(jy), atol=TOL)
    # The carry stays stream-sharded for the next step: 8 parts of 2 lanes.
    assert new_state.starts == tuple(range(0, B, 2))
    assert all(p.conv.fdl.shape[-1] == 2 and p.eq.s_to.shape[0] == 2
               for p in new_state.parts)
    # And steps again from it (the whole input split by the step).
    _, y2 = step(tc, te, te, new_state, torch.from_numpy(x))
    assert torch.isfinite(y2.gather()).all()


def test_stream_speaker_sharded_step_psum_downmix(devices):
    B, S, T = 8, 2, 64
    jc, je, js, tc, te, ts, x, _ = _build(B, S=S, T=T)
    _, ref_y = jchain_step(jc, je, je, js, x, transition_length=960,
                           spatial_enabled=True, eq_enabled=True)
    jm = jmesh.make_mesh(devices, ("streams", "speakers"), shape=(4, 2))
    _, jy = jmesh.stream_speaker_sharded_step(jm, transition_length=960)(
        jc, je, je, _build(B, S=S, T=T)[2], x)

    m = tmesh.make_mesh(CPU8, ("streams", "speakers"), shape=(4, 2))
    step = tmesh.stream_speaker_sharded_step(m, transition_length=960)
    state, y = step(tc, te, te, ts, torch.from_numpy(x))
    np.testing.assert_allclose(y.gather().numpy(), np.asarray(ref_y),
                               atol=TOL)
    np.testing.assert_allclose(y.gather().numpy(), np.asarray(jy), atol=TOL)
    # Each speaker shard holds its speaker of the delay line.
    assert all(c.fdl.shape[1] == 1 for p in state.parts for c in p.convs)
    assert state.gather().conv.fdl.shape == ts.conv.fdl.shape


def test_multihost_helpers_single_process(devices):
    """One process: initialize is a no-op, the process owns the whole
    batch, and make_global_array's parts are the row blocks, feeding the
    sharded step directly."""
    tmh.initialize()
    mesh = tmh.global_mesh(devices=CPU8)
    assert mesh.size == 8 and (mesh.process_index == 0).all()
    spec = tmh.host_shard_spec(16, mesh)
    assert spec.local_count == 16 and spec.local_start == 0

    rows = np.random.default_rng(0).standard_normal((16, 2, 8)).astype(
        np.float32)
    arr = tmh.make_global_array(rows, spec, mesh)
    assert arr.batch == 16 and arr.starts == tuple(range(0, 16, 2))
    np.testing.assert_array_equal(arr.gather().numpy(), rows)

    jc, je, js, tc, te, ts, _, _ = _build(16, T=8, L=16)
    step = tmesh.stream_sharded_step(mesh, transition_length=960)
    _, y = step(tc, te, te, tmesh.shard_chain_state(ts, mesh), arr)
    assert y.gather().shape == (16, 2, 8)
    jm = jmesh.make_mesh(devices, ("streams",))
    _, jy = jmesh.stream_sharded_step(jm, transition_length=960)(
        jc, je, je, jmesh.shard_chain_state(js, jm), rows)
    np.testing.assert_allclose(y.gather().numpy(), np.asarray(jy), atol=TOL)
    with pytest.raises(ValueError, match="backend"):
        tmh.initialize("127.0.0.1:1", 2, 0)


def test_stream_sharded_bake_matches_bake(devices):
    B, S, T, N = 16, 2, 64, 5
    rng = np.random.default_rng(0)
    hrir = (rng.standard_normal((S, 2, 200)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((B, S, N * T)) * 0.4).astype(np.float32)
    want, _ = jbake.bake(hrir, x, SR, block_size=T, pad_to_pow2=True)

    m = tmesh.make_mesh(CPU8)
    _, _, _, _, te, ts, _, _ = _build(B, S=S, T=T, L=200)
    tc = tupols.make_conv_params(hrir, T, device="cpu")
    blocks = torch.from_numpy(np.moveaxis(x.reshape(B, S, N, T), 2, 0).copy())
    runner = tmesh.stream_sharded_bake(m, transition_length=960,
                                       eq_enabled=False)
    _, y_blocks = runner(tc, te, te, tmesh.shard_chain_state(ts, m), blocks)
    got = np.moveaxis(y_blocks.gather().numpy(), 0, 2).reshape(B, 2, N * T)
    np.testing.assert_allclose(got, want, atol=2e-5)

    jm = jmesh.make_mesh(devices, ("streams",))
    jc = jupols.make_conv_params(hrir, T)
    jrun = jmesh.stream_sharded_bake(jm, transition_length=960,
                                     eq_enabled=False)
    js = jmesh.shard_chain_state(_build(B, S=S, T=T, L=200)[2], jm)
    _, jy = jrun(jc, jeq.unity_eq_params(T, 16), jeq.unity_eq_params(T, 16),
                 js, jnp.asarray(blocks.numpy()))
    np.testing.assert_allclose(y_blocks.gather().numpy(), np.asarray(jy),
                               atol=TOL)


def test_stream_sharded_bake_multi_matches_bake(devices):
    """The M-block lookahead bake with the folded EQ over the 8 shards
    against the JAX package's bake, and its paged carry stays sharded."""
    B, S, T, M, NSTEPS = 16, 2, 64, 4, 3
    rng = np.random.default_rng(1)
    hrir = (rng.standard_normal((S, 2, 200)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((B, S, NSTEPS * M * T)) * 0.4).astype(np.float32)
    jpre, jco = jbd.design_cascade(japo.EqualizerDefinition(-2.0, (
        japo.EqualizerFilter(1, 1, True, japo.FilterType.PEAKING, 900.0, 3.0,
                             1.1),)), SR)
    tpre, tco = tbd.design_cascade(tapo.EqualizerDefinition(-2.0, (
        tapo.EqualizerFilter(1, 1, True, tapo.FilterType.PEAKING, 900.0, 3.0,
                             1.1),)), SR)
    want, _ = jbake.bake(hrir, x, SR, jco, jpre, block_size=T,
                         pad_to_pow2=False, blocks_per_step=M)

    tc = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    te = teq.make_eq_params(tco, tpre, T, 16, device="cpu")
    state = TChainState(
        conv=tupols.make_conv_state_paged(B, S, tc.partition_count, T, M,
                                          "cpu"),
        eq=teq.make_eq_state(B, 2, 16, "cpu"))
    m = tmesh.make_mesh(CPU8)
    n_pages = len(state.conv.pages)
    run = tmesh.stream_sharded_bake_multi(m, n_pages, transition_length=960,
                                          eq_enabled=True)
    steps = torch.from_numpy(
        np.moveaxis(x.reshape(B, S, NSTEPS, M, T), 2, 0).copy())
    new_state, y_steps = run(tc, te, te, tmesh.shard_chain_state(state, m),
                             steps)
    got = np.transpose(y_steps.gather().numpy(), (1, 3, 0, 2, 4)).reshape(
        B, 2, NSTEPS * M * T)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert all(len(p.conv.pages) == n_pages
               and p.conv.pages[0].shape[-1] == 2 for p in new_state.parts)
    with pytest.raises(ValueError, match="pages"):
        tmesh.stream_sharded_bake_multi(m, n_pages + 1)(
            tc, te, te, new_state, steps)


def test_host_shard_spec_multi_axis_mesh():
    """On a 2-D (streams x speakers) mesh the batch divides by the STREAMS
    axis only; make_global_array gives every device the row block of its
    streams coordinate."""
    mesh = tmesh.make_mesh(CPU8, ("streams", "speakers"), shape=(4, 2))
    spec = tmh.host_shard_spec(16, mesh)
    assert spec.local_count == 16 and spec.local_start == 0
    rows = np.random.default_rng(7).standard_normal((16, 3)).astype(
        np.float32)
    arr = tmh.make_global_array(rows, spec, mesh)
    assert len(arr.parts) == 8
    assert arr.starts == (0, 0, 4, 4, 8, 8, 12, 12)
    for start, part in zip(arr.starts, arr.parts):
        np.testing.assert_array_equal(part.numpy(), rows[start:start + 4])
    np.testing.assert_array_equal(arr.gather().numpy(), rows)
    with pytest.raises(ValueError, match="divide"):
        tmh.host_shard_spec(10, mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost_parity(tmp_path):
    """Two processes on gloo (4 virtual CPU shards each, 8 global):
    host_shard_spec, make_global_array and the stream-sharded step across
    the process boundary, and a speaker-sharded step whose rows span both
    processes (an all_reduce a block); the union of both processes' rows
    against the JAX package's single-process chain within 1e-5."""
    worker = os.path.join(os.path.dirname(__file__),
                          "_torch_multihost_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""  # the CPU run never touches a card
    procs = [subprocess.Popen([sys.executable, worker, coord, "2", str(pid),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (f"worker rc={p.returncode}\n"
                                   f"{out.decode()[-2000:]}\n"
                                   f"{err.decode()[-2000:]}")

    import importlib.util

    spec = importlib.util.spec_from_file_location("tmh_worker", worker)
    wk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wk)
    hrir, x = wk.build_inputs()
    B, n_blocks = wk.GLOBAL_BATCH, wk.N_BLOCKS
    got = np.zeros((n_blocks, B, 2, wk.T), np.float32)
    covered = np.zeros(B, bool)
    speakers = []
    for pid in range(2):
        with np.load(tmp_path / f"out_{pid}.npz") as data:
            start, count = int(data["start"]), int(data["count"])
            assert count == B // 2
            covered[start:start + count] = True
            for key in data.files:
                if key.startswith("block"):
                    blk, row = key.replace("block", "").split("_row")
                    rows = data[key]
                    got[int(blk), int(row):int(row) + rows.shape[0]] = rows
            speakers.append(np.stack([data[f"speakers{i}"]
                                      for i in range(n_blocks)]))
            # Each of the process's 4 shards (stream step) and 4 speaker
            # shards (one in each row) calls the MAC once a block, every
            # call held against the plain version.
            for step in ("streams", "speakers"):
                checks = json.loads(str(data[f"mac_checks_{step}"]))
                assert sum(c["launches"] for c in checks.values()) == (
                    4 * n_blocks), checks
                assert all(c["max_abs_err"] == 0 for c in checks.values())
    assert covered.all(), "both processes together must cover the batch"

    from airwave_tpu.models.binaural import chain_step_fn

    conv_params = jupols.make_conv_params(hrir, wk.T, pad_to_pow2=False)
    preamp, coeffs = jbd.design_cascade(japo.EqualizerDefinition(
        preamp_db=-3.0), SR)
    eq_params = jeq.make_eq_params(coeffs, preamp, wk.T)
    state = JChainState(
        conv=jupols.make_conv_state(B, wk.S, conv_params.partition_count,
                                    wk.T),
        eq=jeq.make_eq_state(B))
    speaker_state = state
    for i in range(n_blocks):
        state, y = chain_step_fn(conv_params, eq_params, eq_params, state,
                                 x[i], transition_length=960,
                                 spatial_enabled=True, eq_enabled=True,
                                 eq_crossfading=False)
        np.testing.assert_allclose(got[i], np.asarray(y), atol=TOL)
        speaker_state, ys = chain_step_fn(
            conv_params, eq_params, eq_params, speaker_state, x[i],
            transition_length=960, spatial_enabled=True, eq_enabled=True)
        for theirs in speakers:  # both processes hold every row's sum
            np.testing.assert_allclose(theirs[i], np.asarray(ys), atol=TOL)


def test_atmos_714_speaker_sharded_step_on_mesh():
    """Config 6: the 7.1.4 renderer's 8 resolved speakers over a (2
    streams x 4 speakers) mesh sum to the single-device chain's downmix,
    and to the JAX package's speaker-sharded step."""
    block, B = 32, 8
    rng = np.random.default_rng(17)
    audio = (rng.standard_normal((14, 120)) * 0.2).astype(np.float32)
    jr = jprepare(JWAVData(SR, audio), jcm.ATMOS_7_1_4, SR, block)
    tr = tprepare(TWAVData(SR, audio), tcm.ATMOS_7_1_4, SR, block,
                  device="cpu")
    assert jr.num_speakers == tr.num_speakers == 8
    x12 = rng.standard_normal((B, 12, block)).astype(np.float32) * 0.3
    x = x12[:, list(tr.input_indices)]
    je = jeq.unity_eq_params(block)
    jstate = JChainState(conv=jupols.make_conv_state(B, 8, jr.partition_count,
                                                     block),
                         eq=jeq.make_eq_state(B))
    _, ref_y = jchain_step(jr.conv_params, je, je, jstate, jnp.asarray(x),
                           transition_length=960, spatial_enabled=True,
                           eq_enabled=True)
    te = teq.unity_eq_params(block, device="cpu")

    def tstate():
        return TChainState(
            conv=tupols.make_conv_state(B, 8, tr.partition_count, block,
                                        "cpu"),
            eq=teq.make_eq_state(B, device="cpu"))

    _, want = tchain_step(tr.conv_params, te, te, tstate(),
                          torch.from_numpy(x), 960, True, True)
    m = tmesh.make_mesh(CPU8, ("streams", "speakers"), shape=(2, 4))
    step = tmesh.stream_speaker_sharded_step(m, transition_length=960)
    _, y = step(tr.conv_params, te, te, tstate(), torch.from_numpy(x))
    np.testing.assert_allclose(y.gather().numpy(), np.asarray(ref_y),
                               atol=TOL)
    np.testing.assert_allclose(y.gather().numpy(), want.numpy(), atol=TOL)


# --- the sharded pool ---------------------------------------------------------


BLOCK = 64


def preset(gain: float) -> bytes:
    return (f"Preamp: -1.0 dB\nFilter 1: ON PK Fc 900 Hz Gain {gain} dB Q 1.0\n"
            f"Filter 2: ON LSC Fc 120 Hz Gain -2.5 dB Q 0.7\n").encode()


def renderers(M=1, seed=5, frames=700, block=BLOCK):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)
    return (jprepare(JWAVData(SR, audio), jcm.STEREO, SR, block, lookahead=M),
            tprepare(TWAVData(SR, audio), tcm.STEREO, SR, block, lookahead=M,
                     device="cpu"))


def drive(pools, sigs, step, rounds, feeds, lanes=None, on_round=None):
    """Feed each pool the same ragged schedule (feeds(rnd) -> per-stream
    bools) and collect each stream's output per pool."""
    lanes = lanes or [list(range(len(sigs)))] * len(pools)
    fed = [0] * len(sigs)
    n = sigs[0].shape[1] // step
    outs = [[[] for _ in sigs] for _ in pools]
    for rnd in range(rounds):
        if on_round is not None:
            on_round(rnd)
        for i, want in enumerate(feeds(rnd)):
            if want and fed[i] < n:
                chunk = sigs[i][:, fed[i] * step:(fed[i] + 1) * step]
                for pool, ls in zip(pools, lanes):
                    pool.push(ls[i], chunk)
                fed[i] += 1
        counts = {pool.pump() for pool in pools}
        assert len(counts) == 1, counts
        for out, pool, ls in zip(outs, pools, lanes):
            for i, s in enumerate(ls):
                out[i].append(pool.pull(s, pool.available(s)))
    return [[np.concatenate(o, 1) for o in out] for out in outs]


@pytest.mark.parametrize("M", [1, 2])
def test_stream_pool_sharded_over_mesh_matches_unsharded(devices, M):
    """A pool whose lane state shards over 8 virtual CPU shards renders the
    unsharded pool's audio (within 1e-6, the JAX test's bound) and the JAX
    sharded pool's (within 1e-5) under the same ragged schedule, pauses
    and debt rolls included; one EQ retarget and one hot-swap mid-stream.
    A lane count that does not divide by the mesh raises, as in JAX."""
    jr, tr = renderers(M)
    jr2, tr2 = renderers(M, seed=9, frames=300)
    jm = jax.sharding.Mesh(np.array(devices[:8]), ("streams",))
    m = tmesh.make_mesh(CPU8)
    kw = dict(block_size=BLOCK, blocks_per_step=M, ring_blocks=64)
    sharded = TPool(8, SR, tr, tapo.parse(preset(2.0), "e"), mesh=m,
                    device="cpu", **kw)
    plain = TPool(8, SR, tr, tapo.parse(preset(2.0), "e"), device="cpu", **kw)
    jpool = JPool(8, SR, jr, japo.parse(preset(2.0), "e"), mesh=jm, **kw)
    with pytest.raises(ValueError, match="mesh size"):
        TPool(9, SR, tr, mesh=m, device="cpu", **kw)
    for pool in (sharded, plain):
        pool.prewarm(include_hotswap=True)
    lanes = [[p.attach() for _ in range(3)] for p in (sharded, plain, jpool)]
    assert lanes[0] == lanes[1] == lanes[2]
    step = M * BLOCK
    rng = np.random.default_rng(31)
    n = 6
    sigs = [(rng.standard_normal((2, n * step)) * 0.3).astype(np.float32)
            for _ in range(3)]

    def control(rnd):
        if rnd == 4:
            for pool, apo in ((sharded, tapo), (plain, tapo), (jpool, japo)):
                pool.set_equalizer(apo.parse(preset(-3.0), "e"))
        if rnd == 7:
            for pool, r in ((sharded, tr2), (plain, tr2), (jpool, jr2)):
                assert pool.set_renderer(r) is True

    got, want, jgot = drive(
        [sharded, plain, jpool], sigs, step, 3 * n,
        lambda rnd: [True, rnd % 2 == 0, rnd % 3 == 0], lanes, control)
    for i in range(3):
        assert np.any(want[i] != 0)
        assert rel_rms(got[i], want[i]) < 1e-6, i
        assert rel_rms(got[i], jgot[i]) < TOL, i
    stats = sharded.stats()
    assert stats["debt_rolls"] > 0 and stats["fade_rounds"] > 0
    assert stats["variant_rounds"] == plain.stats()["variant_rounds"]


def test_grouped_pool_over_mesh_matches_unsharded(devices):
    """Two profile groups over a 4-shard mesh (tests/test_grouped.py:496):
    each group's lanes shard on their own, and the audio matches the
    unsharded grouped pool and the JAX grouped pool over its mesh."""
    jr0, tr0 = renderers(seed=50, frames=2 * BLOCK)
    jr1, tr1 = renderers(seed=51, frames=2 * BLOCK)
    jm = jmesh.make_mesh(jax.devices("cpu")[:4], ("streams",))
    jpool = JPool(8, SR, block_size=BLOCK, mesh=jm, profiles=[
        JProfile(jr0, japo.parse(preset(1.0), "e")), JProfile(jr1, None)])
    tprofiles = [TProfile(tr0, tapo.parse(preset(1.0), "e")),
                 TProfile(tr1, None)]
    sharded = TPool(8, SR, block_size=BLOCK, profiles=tprofiles,
                    mesh=tmesh.make_mesh(["cpu"] * 4), device="cpu")
    plain = TPool(8, SR, block_size=BLOCK, profiles=tprofiles, device="cpu")
    with pytest.raises(ValueError, match="mesh size"):
        TPool(8, SR, block_size=BLOCK, profiles=tprofiles,
              mesh=tmesh.make_mesh(CPU8), device="cpu")
    lanes = [[p.attach(g) for g in (0, 0, 1, 1)]
             for p in (sharded, plain, jpool)]
    assert lanes[0] == lanes[1] == lanes[2]
    rng = np.random.default_rng(52)
    sigs = [(rng.standard_normal((2, 6 * BLOCK)) * 0.4).astype(np.float32)
            for _ in range(4)]
    schedule = rng.random((12, 4)) < 0.75
    schedule[0] = True

    def control(rnd):
        if rnd == 3:
            for pool, r in ((sharded, tr0), (plain, tr0), (jpool, jr0)):
                pool.set_renderer(r, group=1)

    got, want, jgot = drive([sharded, plain, jpool], sigs, BLOCK, 12,
                            lambda rnd: schedule[rnd], lanes, control)
    for i in range(4):
        assert np.abs(want[i]).max() > 1e-3
        assert rel_rms(got[i], want[i]) < 1e-6, i
        assert rel_rms(got[i], jgot[i]) < TOL, i


def _snapshot_arrays(snap) -> list:
    """Every array of a pool snapshot's carry and debt, in a fixed order."""
    leaves = []
    tmesh.tree_map(lambda t: leaves.append(np.asarray(t)), snap["state"])
    return leaves + [np.asarray(snap["debt"])]


@pytest.mark.parametrize("M", [1, 2])
def test_snapshots_move_between_sharded_and_unsharded_pools(M):
    """A sharded pool's snapshot is the unsharded format: an unsharded port
    pool restores it and snapshots it back bit for bit, a fresh sharded
    pool restored from it continues bit for bit with the uninterrupted
    pool, the unsharded one within 1e-5 (its GEMMs round differently at
    another lane count), the JAX pool within 1e-5; and a JAX pool's
    snapshot restores into the sharded pool, which then continues within
    1e-5 of the JAX pool."""
    jr, tr = renderers(M)
    kw = dict(block_size=BLOCK, blocks_per_step=M, ring_blocks=64)
    m = tmesh.make_mesh(["cpu"] * 4)
    eq = (tapo.parse(preset(2.0), "e"), japo.parse(preset(2.0), "e"))
    a = TPool(8, SR, tr, eq[0], mesh=m, device="cpu", **kw)
    lanes = [a.attach() for _ in range(3)]
    step = M * BLOCK
    rng = np.random.default_rng(8)
    sigs = [(rng.standard_normal((2, 8 * step)) * 0.3).astype(np.float32)
            for _ in lanes]
    drive([a], [s[:, :4 * step] for s in sigs], step, 6,
          lambda rnd: [True, rnd % 2 == 0, rnd != 1])
    snap = a.snapshot()
    assert snap["debt"].any()  # a paused lane carries debt across the move
    resumed = TPool(8, SR, tr, eq[0], mesh=m, device="cpu", **kw)
    resumed.restore(snap)
    plain = TPool(8, SR, tr, eq[0], device="cpu", **kw)
    plain.restore(snap)
    for x, y in zip(_snapshot_arrays(plain.snapshot()),
                    _snapshot_arrays(snap)):
        np.testing.assert_array_equal(x, y)
    j = JPool(8, SR, jr, eq[1], **kw)
    j.restore(interop.pool_snapshot_to_numpy(snap, japo, jbd))
    rest = [s[:, 4 * step:] for s in sigs]
    got, again, flat, jgot = drive([a, resumed, plain, j], rest, step, 6,
                                   lambda rnd: [True, True, rnd % 2 == 0])
    for i in range(3):
        np.testing.assert_array_equal(again[i], got[i])
        assert rel_rms(flat[i], got[i]) < TOL, i
        assert rel_rms(got[i], jgot[i]) < TOL, i

    back = TPool(8, SR, tr, eq[0], mesh=m, device="cpu", **kw)
    back.restore(interop.pool_snapshot_from_numpy(j.snapshot(),
                                                  device="cpu"))
    more = [(rng.standard_normal((2, 3 * step)) * 0.3).astype(np.float32)
            for _ in lanes]
    got, jgot = drive([back, j], more, step, 3, lambda rnd: [True] * 3)
    for i in range(3):
        assert np.any(jgot[i] != 0)
        assert rel_rms(got[i], jgot[i]) < TOL, i


def test_pool_mesh_checks():
    """The JAX pool's mesh checks, and the pool's device is the mesh's."""
    _, tr = renderers()
    m2 = tmesh.make_mesh(["cpu"] * 4, ("streams", "speakers"), shape=(2, 2))
    with pytest.raises(ValueError, match="1-D with axis name 'streams'"):
        TPool(4, SR, tr, block_size=BLOCK, mesh=m2)
    other = tmesh.Mesh(np.array([torch.device("cpu")] * 2, dtype=object),
                       ("streams",), np.array([0, 1]))
    with pytest.raises(ValueError, match="one pool per process"):
        TPool(4, SR, tr, block_size=BLOCK, mesh=other)
    pool = TPool(4, SR, tr, block_size=BLOCK, mesh=tmesh.make_mesh(["cpu"] * 2))
    assert pool.device == torch.device("cpu") and pool.shard_count == 2


# --- serve --mesh-devices ------------------------------------------------------


def _hrir_file(tmp_path) -> str:
    audio = (np.random.default_rng(3).standard_normal((14, 300)) * 0.2).astype(
        np.float32)
    path = str(tmp_path / "hrir.wav")
    twav.save(path, audio, SR)
    return path


@pytest.mark.parametrize("flags,error", [
    (["--mesh-devices", "2"], "--mesh-devices 2: only 0 devices visible"),
    (["--cpu", "--mesh-devices", "3", "--max-streams", "8"],
     "--max-streams 8 must divide by --mesh-devices 3"),
], ids=["devices", "divide"])
def test_serve_mesh_devices_errors(tmp_path, flags, error):
    """The JAX CLI's two errors: too few cards visible (checked before
    anything touches one), and a lane count that does not divide."""
    if "--cpu" not in flags and torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    with pytest.raises(SystemExit, match=error):
        tmain(["serve", "--hrir", _hrir_file(tmp_path), "--port", "0",
               *flags])


def test_serve_mesh_devices_cpu_listens_and_renders(tmp_path):
    """`serve --cpu --mesh-devices 2` as a process: its listening line says
    mesh_devices 2, a client's stream renders, SIGINT exits 0."""
    from airwave_tpu_torch.shell.wire_client import render_via_server

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "airwave_tpu_torch", "serve", "--cpu",
         "--hrir", _hrir_file(tmp_path), "--port", "0", "--max-streams", "4",
         "--mesh-devices", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines, ready = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(json.loads(line))
            if "listening" in lines[-1]:
                ready.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        assert ready.wait(120), proc.stderr.read()
        listening = next(line for line in lines if "listening" in line)
        assert listening["mesh_devices"] == 2
        assert listening["max_streams"] == 4
        sig = (np.random.default_rng(4).standard_normal((2, 3 * BLOCK + 11))
               * 0.3).astype(np.float32)
        out = render_via_server(tuple(listening["listening"]), sig, chunk=97)
        assert out.shape == sig.shape and np.abs(out).max() > 1e-4
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0
    finally:
        proc.kill()
