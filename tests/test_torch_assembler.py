"""native/ of the PyTorch port: its RaggedAssembler, with the C++ rings and
with the NumPy implementation, against the JAX package's over one seeded
sequence of pushes, harvests, scatters and pops (wraparound and overflow
included). The results must be equal. The port never falls back silently:
a library that cannot be built raises."""

import numpy as np
import pytest

from airwave_tpu.native import RaggedAssembler as JAssembler
from airwave_tpu_torch import native as tnative


def _call(fn, *args):
    try:
        return fn(*args)
    except (OverflowError, ValueError) as err:
        return type(err).__name__


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_assembler_matches_jax_over_a_seeded_sequence(impl):
    n, C, block, cap = 5, 2, 8, 40
    t = tnative.RaggedAssembler(n, C, block, capacity=cap, impl=impl)
    j = JAssembler(n, C, block, capacity=cap, force_python=False)
    assert t.is_native == (impl == "native")
    rng = np.random.default_rng(11)
    seen = {"rows": 0, "OverflowError": 0}
    for step in range(400):
        op = rng.choice(["push", "push_many", "harvest", "scatter_pop",
                         "pop_many", "free"])
        if op == "push":
            s, m = int(rng.integers(0, n)), int(rng.integers(1, 30))
            chunk = rng.standard_normal((C, m)).astype(np.float32)
            res = _call(t.push, s, chunk)
            _same(res, _call(j.push, s, chunk))
            seen["OverflowError"] += res == "OverflowError"
        elif op == "push_many":
            k = int(rng.integers(0, 4))
            streams = rng.integers(0, n, k).astype(np.int32)  # duplicates too
            chunks = rng.standard_normal((k, C, int(rng.integers(0, 12)))
                                         ).astype(np.float32)
            _same(_call(t.push_many, streams, chunks),
                  _call(j.push_many, streams, chunks))
        elif op == "harvest":
            allow = rng.random(n) < 0.7
            frames = int(rng.choice([block, 2 * block]))
            max_batch = int(rng.integers(1, n + 1))
            got = t.harvest_allowed(max_batch, allow, frames)
            ref = j.harvest_allowed(max_batch, allow, frames)
            _same(got, ref)
            seen["rows"] += len(got[0])
            if len(got[0]):
                out = (got[1] * 0.5).astype(np.float32)
                _same(_call(t.scatter, got[0], out), _call(j.scatter, ref[0], out))
        elif op == "scatter_pop":
            s, m = int(rng.integers(0, n)), int(rng.integers(0, 20))
            chunk = rng.standard_normal((C, m)).astype(np.float32)
            _same(t.try_push_out(s, chunk), j.try_push_out(s, chunk))
            w = int(rng.integers(1, 20))
            _same(t.pop(s, w), j.pop(s, w))
        elif op == "pop_many":
            streams = rng.permutation(n)[: int(rng.integers(0, n))].astype(np.int32)
            w = int(rng.integers(0, 16))
            _same(t.pop_many(streams, w), j.pop_many(streams, w))
        else:
            _same(t.out_free_all(), j.out_free_all())
            for s in range(n):
                _same((t.pending(s), t.out_available(s)),
                      (j.pending(s), j.out_available(s)))
            _same(t.ready_count(), j.ready_count())
        if step % 97 == 0:
            s = int(rng.integers(0, n))
            t.reset_stream(s)
            j.reset_stream(s)
    assert seen["rows"] > 20 and seen["OverflowError"] > 0, seen
    t.close()
    t.close()  # idempotent


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_assembler_contract_edges(impl):
    """Wraparound keeps order; overflow and invalid ids raise and write
    nothing; harvest can write into a caller's buffer."""
    a = tnative.RaggedAssembler(2, 1, block=4, capacity=8, impl=impl)
    seq = np.arange(1, 100, dtype=np.float32)
    popped, cursor = [], 0
    for _ in range(10):
        a.push(0, seq[cursor:cursor + 6][None])
        cursor += 6
        while a.ready_count():
            idx, blk = a.harvest_allowed(2, np.ones(2, bool))
            a.scatter(idx, blk)
        popped.append(a.pop(0, 6))
    out = np.concatenate(popped, axis=1)[0]
    nonzero = out[out != 0]
    np.testing.assert_array_equal(nonzero, seq[: len(nonzero)])
    with pytest.raises(OverflowError):
        a.push(0, np.ones((1, 100), np.float32))
    with pytest.raises(OverflowError):
        a.push_many(np.array([1, 1], np.int32), np.ones((2, 1, 5), np.float32))
    assert a.pending(1) == 0
    with pytest.raises(ValueError):
        a.pop_many(np.array([1, 9], np.int32), 4)
    with pytest.raises(ValueError):
        a.push_many(np.array([9], np.int32), np.zeros((1, 1, 0), np.float32))
    a.push(1, np.arange(8, dtype=np.float32)[None])
    buf = np.full((2, 1, 8), -1.0, np.float32)
    idx, blocks = a.harvest_allowed(2, np.array([False, True]), frames=8,
                                    out=buf)
    assert list(idx) == [1] and blocks.base is buf
    np.testing.assert_array_equal(buf[0, 0], np.arange(8))
    with pytest.raises(ValueError):
        a.harvest_allowed(2, np.ones(2, bool), frames=8,
                          out=np.zeros((1, 1, 8), np.float32))


def test_native_build_failure_raises(monkeypatch):
    """No compiler: the native assembler raises, it does not fall back."""
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    tnative.load_library.cache_clear()
    try:
        with pytest.raises(tnative.AssemblerBuildError, match="g\\+\\+"):
            tnative.RaggedAssembler(2, 1, 4, impl="native")
    finally:
        tnative.load_library.cache_clear()
    with pytest.raises(ValueError, match="impl"):
        tnative.RaggedAssembler(2, 1, 4, impl="python")
