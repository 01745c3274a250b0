"""utils/checkpoint (save_pytree, load_pytree, both containers, the round-3
full-window migration) and upols.migrate_full_window_fdl of the port
against the JAX package's, on the CPU.

Files go both ways: pool carries of both tiers, one-profile and grouped,
written by each package in each container and read by the other, leaf for
leaf. The migration's recursion equals the JAX one bit for bit; the
committed round-3 fixtures (tests/fixtures/r3_*full_window_pool.npz)
restore into port pools that continue within 1e-5 of the JAX pools'
continuation and of the uninterrupted render (tests/test_migration.py);
every other kind of file the JAX loader refuses raises the same versioned
error here (tests/test_serve.py:1159-1222). Shapes are the JAX tests':
block 64, 4-8 lanes.
"""

import os
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.ops import upols as jupols
from airwave_tpu.runtime.stream_pool import PoolProfile as JProfile
from airwave_tpu.runtime.stream_pool import StreamPool as JPool
from airwave_tpu.utils import checkpoint as jckpt
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.runtime.stream_pool import PoolProfile as TProfile
from airwave_tpu_torch.runtime.stream_pool import StreamPool as TPool
from airwave_tpu_torch.shell.app import restore_serve_checkpoint
from airwave_tpu_torch.utils import checkpoint as tckpt

SR = 48_000.0
BLOCK = 64
TOL = 1e-5
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / max(
        np.sqrt(np.mean(ref ** 2)), 1e-12)


def bank(seed, frames=300):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)


def pools(lanes, M, grouped, banks=((5, 300), (6, 150))):
    """(JAX pool, port pool) of one construction."""
    def renderers(prepare, wav_cls, cm, **kw):
        return [prepare(wav_cls(SR, bank(s, n)), cm.STEREO, SR, BLOCK,
                        lookahead=M, **kw) for s, n in banks]

    jr = renderers(jprepare, JWAVData, jcm)
    tr = renderers(tprepare, TWAVData, tcm, device="cpu")
    if grouped:
        return (JPool(lanes, SR, None, block_size=BLOCK, blocks_per_step=M,
                      profiles=[JProfile(r) for r in jr]),
                TPool(lanes, SR, None, block_size=BLOCK, blocks_per_step=M,
                      profiles=[TProfile(r) for r in tr], device="cpu"))
    return (JPool(lanes, SR, jr[0], block_size=BLOCK, blocks_per_step=M),
            TPool(lanes, SR, tr[0], block_size=BLOCK, blocks_per_step=M,
                  device="cpu"))


def feed(pool_pair, rounds, seed):
    """Attach two lanes per group on both pools and run the same ragged
    rounds (lane 1 skips every third), so each carry holds history and
    debt."""
    rng = np.random.default_rng(seed)
    lanes = []
    for pool in pool_pair:
        lanes.append([pool.attach(g) for g in range(pool.groups)
                      for _ in range(2)])
    step = pool_pair[0].blocks_per_step * BLOCK
    for r in range(rounds):
        xs = rng.standard_normal((len(lanes[0]), 2, step)).astype(np.float32)
        for pool, ls in zip(pool_pair, lanes):
            for i, (lane, x) in enumerate(zip(ls, xs)):
                if i == 1 and r % 3 == 2:
                    continue
                pool.push(lane, x)
            pool.pump()
            for lane in ls:
                n = pool.available(lane)
                if n:
                    pool.pull(lane, n)


def jax_tree(pool):
    snap = pool.snapshot()
    return {"state": jax.tree_util.tree_map(np.asarray, snap["state"]),
            "debt": np.asarray(snap["debt"])}


def port_tree(pool):
    snap = pool.snapshot()
    return tckpt._host_tree(snap["state"], snap["debt"])


def leaves_equal(got, want):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("grouped", [False, True], ids=["one", "grouped"])
@pytest.mark.parametrize("M", [1, 4], ids=["ring", "paged"])
@pytest.mark.parametrize("container", ["npz", "raw"])
def test_pool_carries_cross_packages(tmp_path, container, M, grouped):
    pair = pools(8, M, grouped)
    feed(pair, 5, seed=M + 2 * grouped)
    jtree, ttree = jax_tree(pair[0]), port_tree(pair[1])
    assert tckpt._treedef_repr(ttree) == str(
        jax.tree_util.tree_structure(jtree))
    extra = {"writer": "x", "n": [1, 2]}

    jpath = str(tmp_path / "from_jax")
    jckpt.save_pytree(jpath, jtree, extra_json=extra, container=container)
    got, got_extra = tckpt.load_pytree(jpath, ttree, with_extra=True)
    leaves_equal(got, jtree)
    assert got_extra == extra == tckpt.load_pytree_extra(jpath)
    assert tckpt.snapshot_lane_count(jpath) == 8

    tpath = str(tmp_path / "from_port")
    tckpt.save_pytree(tpath, ttree, extra_json=extra, container=container)
    with open(tckpt.checkpoint_path(tpath), "rb") as f:
        assert f.read(8).startswith(b"AWSNAP1\n" if container == "raw"
                                    else b"PK\x03\x04")
    got, got_extra = jckpt.load_pytree(tpath, jtree, with_extra=True)
    leaves_equal(got, ttree)
    assert got_extra == extra == jckpt.load_pytree_extra(tpath)
    assert jckpt.snapshot_lane_count(tpath) == 8


def test_save_pytree_takes_tensors_lists_and_none(tmp_path):
    """A carry of tensors (fetched), lists and None nodes writes as JAX
    writes the same pytree of numpy arrays."""
    import torch

    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array(3, np.int32), np.ones(4, np.int64)]
    jtree = {"a": [arrays[0], None], "b": (arrays[1], arrays[2])}
    ttree = {"a": [torch.from_numpy(arrays[0]), None],
             "b": (arrays[1], torch.from_numpy(arrays[2]))}
    for container in ("npz", "raw"):
        path = str(tmp_path / container)
        tckpt.save_pytree(path, ttree, container=container)
        leaves_equal(jckpt.load_pytree(path, jtree), jtree)
        assert tckpt._treedef_repr(ttree) == str(
            jax.tree_util.tree_structure(jtree))


@pytest.mark.parametrize("container", ["npz", "raw"])
def test_mismatches_raise_the_jax_errors(tmp_path, container):
    """Structure, shape and dtype mismatches raise the JAX package's
    ValueError text; extra_check runs before them; a file without extra
    reads None."""
    tree = {"a": np.zeros(4, np.float32), "b": np.zeros((), np.int32)}
    path = str(tmp_path / "t")
    jckpt.save_pytree(path, tree, container=container)
    assert tckpt.load_pytree_extra(path) is None
    assert tckpt.load_pytree(path, tree, with_extra=True)[1] is None
    likes = {
        "structure": {"a": np.zeros(4, np.float32)},
        "shape": {"a": np.zeros(5, np.float32), "b": np.zeros((), np.int32)},
        "dtype": {"a": np.zeros(4, np.float64), "b": np.zeros((), np.int32)},
    }
    for name, like in likes.items():
        errors = []
        for ckpt in (jckpt, tckpt):
            with pytest.raises(ValueError) as err:
                ckpt.load_pytree(path, like)
            errors.append(str(err.value))
        assert errors[0] == errors[1], name
        assert {"structure": "structure mismatch", "shape": "leaf_0: shape",
                "dtype": "leaf_0: dtype"}[name] in errors[1]
    seen = []

    def check(extra):
        seen.append(extra)
        raise ValueError("refused by the check")

    with pytest.raises(ValueError, match="refused by the check"):
        tckpt.load_pytree(path, likes["structure"], extra_check=check)
    assert seen == [None]


@pytest.mark.parametrize("container", ["npz", "raw"])
def test_extension_dtype_the_port_cannot_represent_raises(tmp_path, container):
    """A bfloat16 leaf written by the JAX package (an __ext_dtypes__ entry
    in npz, an ext leaf in raw) raises a ValueError naming the dtype."""
    tree = {"w": np.ones(3, ml_dtypes.bfloat16)}
    path = str(tmp_path / "bf16")
    jckpt.save_pytree(path, tree, container=container)
    assert jckpt.load_pytree(path, tree)["w"].dtype == ml_dtypes.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.load_pytree(path, {"w": np.ones(3, np.float32)})


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_migration_recursion_equals_jax(seed):
    """tests/test_migration.py:34's construction: the full-window line
    built from its definition, with per-lane debt; the port's migration
    equals the JAX one bit for bit and the half-window truth within 1e-5."""
    rng = np.random.default_rng(seed)
    T = 64
    K = T + 1
    P = int(rng.integers(1, 9)) if seed < 3 else 94
    S, B = 2, 3
    kp = K + int(rng.integers(0, 4))
    w = int(rng.integers(0, P))
    blocks = rng.standard_normal((P + 1, B, S, T)).astype(np.float32)
    padded = np.zeros((P + 1, B, S, 2 * T), np.float64)
    padded[..., :T] = blocks
    u = np.transpose(np.fft.rfft(padded, axis=-1), (0, 3, 2, 1))
    s = ((-1.0) ** np.arange(K))[:, None, None]
    fdl_old = np.zeros((kp, S, P, 2, B), np.float32)
    for j in range(P):
        X = u[P - j - 1] + s * u[P - j]
        slot = (w - 1 - j) % P
        fdl_old[:K, :, slot, 0, :] = X.real
        fdl_old[:K, :, slot, 1, :] = X.imag
    overlap = blocks[P]
    debt = rng.integers(0, P + 3, size=B)
    stored = fdl_old.copy()
    for b in range(B):
        src = (np.arange(P) + debt[b]) % P
        stored[:, :, :, :, b] = np.take(fdl_old[:, :, :, :, b], src, axis=2)
    before = stored.copy()

    got = tupols.migrate_full_window_fdl(stored, overlap, w, debt)
    want = jupols.migrate_full_window_fdl(stored, overlap, w, debt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stored, before)  # the input is not mutated
    assert got.shape == (kp, S, P + 1, 2, B) and got.dtype == np.float32
    for j in range(P + 1):
        slot = (w - 1 - j) % (P + 1)
        for plane, part in ((0, u[P - j].real), (1, u[P - j].imag)):
            err = (np.abs(got[:K, :, slot, plane, :] - part).max()
                   / max(np.abs(part).max(), 1e-12))
            assert err < TOL, (j, plane, err)
    assert not np.any(got[K:])


def _r3_pools(grouped):
    """(inputs, JAX pool factory, port pool factory) of a round-3 fixture,
    built as tests/test_migration.py:95,169 builds them."""
    d = np.load(os.path.join(
        FIXDIR, f"r3_{'grouped_' if grouped else ''}full_window_inputs.npz"))
    block = int(d["block"])
    audios = ([d["hrir_a"], d["hrir_b"]] if grouped else [d["hrir_audio"]])

    def factory(prepare, wav_cls, cm, pool_cls, profile_cls, **kw):
        rs = [prepare(wav_cls(SR, a), cm.STEREO, SR, block, **kw)
              for a in audios]

        def build():
            if grouped:
                return pool_cls(4, SR, None, block_size=block,
                                profiles=[profile_cls(r) for r in rs], **kw)
            return pool_cls(4, SR, rs[0], block_size=block, **kw)
        return build

    return (d, factory(jprepare, JWAVData, jcm, JPool, JProfile),
            factory(tprepare, TWAVData, tcm, TPool, TProfile, device="cpu"))


def _render(pool, lanes, streams, block, n_blocks):
    out = [[] for _ in lanes]
    for t in range(n_blocks):
        for j, lane in enumerate(lanes):
            if t < streams[j].shape[1] // block:
                pool.push(lane, streams[j][:, t * block:(t + 1) * block])
        pool.pump()
        for j, lane in enumerate(lanes):
            n = pool.available(lane)
            if n:
                out[j].append(pool.pull(lane, n))
    return [np.concatenate(o, axis=1) for o in out]


@pytest.mark.parametrize("grouped", [False, True], ids=["ring", "grouped"])
def test_round3_fixture_migrates_and_continues_as_jax(grouped):
    d, jbuild, tbuild = _r3_pools(grouped)
    block = int(d["block"])
    n_pre, n_post = int(d["n_pre"]), int(d["n_post"])
    x, extra_a = d["x"], d["extra_a"]
    name = f"r3_{'grouped_' if grouped else ''}full_window_pool"
    path = os.path.join(FIXDIR, name)

    # The uninterrupted render on the port (lane a played 2 extra blocks
    # while lane b was paused).
    streams = [np.concatenate([x[0, :, :n_pre * block], extra_a,
                               x[0, :, n_pre * block:]], axis=1),
               np.concatenate([x[1, :, :n_pre * block],
                               x[1, :, n_pre * block:]], axis=1)]
    ref = tbuild()
    ref_lanes = ([ref.attach(0), ref.attach(1)] if grouped
                 else [ref.attach(), ref.attach()])
    ref_out = _render(ref, ref_lanes, streams, block,
                      max(s.shape[1] // block for s in streams))
    tails = [ref_out[0][:, (n_pre + 2) * block:],
             ref_out[1][:, n_pre * block:]]
    post = [x[j, :, n_pre * block:] for j in range(2)]

    conts = {}
    for pkg, build, ckpt in (("jax", jbuild, jckpt), ("port", tbuild, tckpt)):
        pool = build()
        snap = ckpt.load_pool_snapshot(path, pool)
        assert snap.get("migrated_from") == "full-window (schema 1)"
        assert not np.any(np.asarray(snap["debt"]))
        pool.restore(snap)
        lanes = snap["attached"]
        assert len(lanes) == 2
        conts[pkg] = _render(pool, lanes, post, block, n_post)
    for j in range(2):
        assert conts["port"][j].shape == tails[j].shape
        assert rel_rms(conts["port"][j], conts["jax"][j]) < TOL, j
        assert rel_rms(conts["port"][j], tails[j]) < TOL, j


def test_round3_fixture_does_not_migrate_into_a_paged_pool():
    """The paged tier has no migration path: the versioned error, as in
    the JAX package."""
    d = np.load(os.path.join(FIXDIR, "r3_full_window_inputs.npz"))
    block = int(d["block"])
    path = os.path.join(FIXDIR, "r3_full_window_pool")
    jr = jprepare(JWAVData(SR, d["hrir_audio"]), jcm.STEREO, SR, block,
                  lookahead=2)
    tr = tprepare(TWAVData(SR, d["hrir_audio"]), tcm.STEREO, SR, block,
                  lookahead=2, device="cpu")
    errors = []
    for ckpt, pool in ((jckpt, JPool(4, SR, jr, block_size=block,
                                     blocks_per_step=2)),
                       (tckpt, TPool(4, SR, tr, block_size=block,
                                     blocks_per_step=2, device="cpu"))):
        with pytest.raises(ckpt.SnapshotCompatError, match=r"schema 1.*schema 2"):
            ckpt.load_pool_snapshot(path, pool)


def test_restore_serve_checkpoint_resumes_round3_file(tmp_path):
    d, _, tbuild = _r3_pools(False)
    path = str(tmp_path / "ckpt")
    shutil.copy(os.path.join(FIXDIR, "r3_full_window_pool.npz"),
                tckpt.checkpoint_path(path))
    pool = tbuild()
    resumed, tokens, aliases = restore_serve_checkpoint(path, pool)
    assert (resumed, tokens, aliases) == (True, {}, None)
    assert sorted(pool._attached) == [0, 1]
    assert os.path.exists(tckpt.checkpoint_path(path))
    assert not os.path.exists(tckpt.checkpoint_path(path) + ".incompatible")


def _versioning_pools():
    audio = bank(43)
    jr = jprepare(JWAVData(SR, audio), jcm.STEREO, SR, BLOCK)
    tr = tprepare(TWAVData(SR, audio), tcm.STEREO, SR, BLOCK, device="cpu")
    return (JPool(4, SR, jr, block_size=BLOCK),
            TPool(4, SR, tr, block_size=BLOCK, device="cpu"))


def _same_error(path, pools_, **kw):
    errors = []
    for ckpt, pool in zip((jckpt, tckpt), pools_):
        with pytest.raises(ckpt.SnapshotCompatError) as err:
            ckpt.load_pool_snapshot(path, pool, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    return errors[1]


def test_prehalfwindow_fixture_raises_the_jax_error():
    msg = _same_error(os.path.join(FIXDIR, "pool_snapshot_prehalfwindow.npz"),
                      _versioning_pools())
    assert "schema 1" in msg and "schema 2" in msg


def test_sidecar_and_schemaless_files_as_jax(tmp_path):
    """tests/test_serve.py:1196-1222: a sidecar-era file (no embedded meta)
    raises the same versioned error; a schema-less one-file snapshot whose
    arrays fit loads in both packages, written by either; at another lane
    count it raises the same pre-versioning error."""
    jpool, tpool = _versioning_pools()
    sidecar = str(tmp_path / "sidecar_era")
    jckpt.save_pytree(sidecar, {"state": np.zeros(3, np.float32),
                                "debt": np.zeros(4, np.int32)})
    assert "schema 1" in _same_error(sidecar, (jpool, tpool))

    jlane, tlane = jpool.attach(), tpool.attach()
    meta = {"attached": [0], "eq_enabled": False, "groups": 1,
            "eq_runtime": {"active": None, "transition_from": None,
                           "pending": None, "samples_into_transition": 0,
                           "reset_requested": False}}
    jsnap, tsnap = jpool.snapshot(), tpool.snapshot()
    jpath, tpath = str(tmp_path / "jax_legacy"), str(tmp_path / "port_legacy")
    jckpt.save_pytree(jpath, {"state": jsnap["state"],
                              "debt": np.asarray(jsnap["debt"])},
                      extra_json=meta)
    tckpt.save_pytree(tpath, tckpt._host_tree(tsnap["state"], tsnap["debt"]),
                      extra_json=meta)
    for path in (jpath, tpath):
        for ckpt, pool in ((jckpt, jpool), (tckpt, tpool)):
            snap = ckpt.load_pool_snapshot(path, pool)
            assert snap["attached"] == [0] and "migrated_from" not in snap
        tpool.restore(tckpt.load_pool_snapshot(path, tpool))
        assert sorted(tpool._attached) == [tlane] == [jlane]

    msg = _same_error(jpath, _versioning_pools(), lanes=8)
    assert "different lane count" in msg
