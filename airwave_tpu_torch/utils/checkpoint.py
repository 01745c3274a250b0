"""Serving checkpoints: a StreamPool snapshot in one file, across processes.

The serving half of airwave_tpu/utils/checkpoint.py, on its raw container
(magic | u64 header length | header JSON | 64-byte aligned leaf payloads).
The files are interchangeable with the JAX package's: the header names the
carry structure as JAX renders the same pytree, one-profile or grouped (a
small formatter over the port's NamedTuples and tuples stands in for
jax.tree_util), the meta carries the same schema number, carry tag and
per-group EQ machines (`eq_runtimes`), and the leaves go to disk in JAX's
flattening order (debt, each group's conv leaves, each group's s_from,
s_to, counter) with JAX's dtypes (the ring cursor, a Python int in the
port's ConvState, as a 0-d int32). A checkpoint written by either package
restores the other's pool of the same construction bit for bit.

Leaves are read with chunked os.preadv into preallocated buffers: the
buffered read paths move tens of MB/s on virtualized hosts even from page
cache. Every malformed file (bad magic, a header that does not parse or
does not describe leaves, a payload shorter than its header says) raises
ValueError, so a serving restart can move it aside instead of crashing.

Not ported (ROADMAP Queue 1 item 16): the npz container and the migration
of round-3 full-window snapshots. Such files, like any file without a
schema number, raise the versioned SnapshotCompatError.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                      FilterType)
from airwave_tpu_torch.ops import upols
from airwave_tpu_torch.ops.biquad_design import BiquadCoefficients

_RAW_MAGIC = b"AWSNAP1\n"
_READ_CHUNK = 64 << 20  # bytes per preadv
# Serving-checkpoint schema (the JAX package's history: 1 was the
# full-window carry; 2 is the half-window carry this port runs).
POOL_SNAPSHOT_SCHEMA = 2


class SnapshotCompatError(ValueError):
    """A pool snapshot from an incompatible format generation (schema or
    carry mismatch), or one whose arrays do not fit the pool. A ValueError,
    so the serving restart's move-aside handler catches it."""


def checkpoint_path(path: str) -> str:
    """The on-disk file a checkpoint path resolves to (the JAX package's
    rule: a ".npz" suffix is appended when missing)."""
    return path if path.endswith(".npz") else path + ".npz"


# --- the carry's structure, as JAX names it --------------------------------


def _treedef_repr(tree: Any) -> str:
    """str(jax.tree_util.tree_structure(tree)) for the trees a pool
    snapshot holds: dicts (keys sorted), NamedTuples, tuples and array
    leaves."""
    return f"PyTreeDef({_node_repr(tree)})"


def _node_repr(node: Any) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_node_repr(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        children = ", ".join(_node_repr(c) for c in node)
        return f"CustomNode(namedtuple[{type(node).__name__}], [{children}])"
    if isinstance(node, tuple):
        inner = ", ".join(_node_repr(c) for c in node)
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    return "*"


def _leaves(tree: Any) -> list:
    """The tree's leaves in JAX's flattening order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for c in tree for leaf in _leaves(c)]
    return [tree]


def _key_names(tree: Any, name: str = "") -> list:
    """The last path key of each leaf of a carry as JAX prints it (".field"
    for a NamedTuple field, "[i]" for a tuple item)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [n for f, c in zip(tree._fields, tree)
                for n in _key_names(c, f".{f}")]
    if isinstance(tree, tuple):
        return [n for i, c in enumerate(tree) for n in _key_names(c, f"[{i}]")]
    return [name]


def _carry_format(state: Any) -> str:
    """The carry tag: the sorted set of the carry's leaf key names, as the
    JAX package writes it."""
    return ",".join(sorted(set(_key_names(state))))


def _unflatten(like: Any, leaves) -> Any:
    """The tree of `like`'s structure with its leaves taken in order from
    the iterator `leaves` (the inverse of _leaves)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(c, leaves) for c in like))
    if isinstance(like, tuple):
        return tuple(_unflatten(c, leaves) for c in like)
    return next(leaves)


def _map_convs(fn, state: Any) -> Any:
    """A pool carry (one-profile or grouped) with fn applied to each conv
    carry."""
    conv = state.conv
    conv = (tuple(fn(c) for c in conv) if type(conv) is tuple else fn(conv))
    return type(state)(conv, state.eq)


def _cursor_leaf(conv):
    """A ring carry with its cursor as the 0-d int32 leaf JAX stores."""
    if hasattr(conv, "pages"):
        return conv
    return upols.ConvState(fdl=conv.fdl,
                           write_pos=np.asarray(int(conv.write_pos), np.int32))


def _host_tree(snap_state: Any, debt: Any) -> dict:
    """{"debt", "state"} with every leaf a numpy array of JAX's dtype: the
    ring cursors as 0-d int32, tensors fetched to the host."""
    def host(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().cpu().numpy()
        return np.asarray(leaf)

    state = _map_convs(_cursor_leaf, snap_state)
    state = _unflatten(state, iter([host(x) for x in _leaves(state)]))
    return {"debt": np.asarray(debt, np.int64), "state": state}


def _expected_leaves(pool, lanes: Optional[int]) -> tuple:
    """(tree of the pool's carry at `lanes` lanes, [(shape, dtype)] per
    leaf in JAX's order) without moving any carry data."""
    if lanes is None:
        state, debt = pool._state, pool._debt
    else:
        like = pool.state_like(lanes)
        state, debt = like["state"], like["debt"]
    tree = {"debt": debt, "state": _map_convs(_cursor_leaf, state)}

    def spec(leaf):
        dtype = (torch.empty((), dtype=leaf.dtype).numpy().dtype
                 if isinstance(leaf, torch.Tensor) else np.asarray(leaf).dtype)
        return tuple(leaf.shape), dtype

    return tree, [spec(leaf) for leaf in _leaves(tree)]


# --- EQ machine metadata ----------------------------------------------------


def _pack_eq_definition(definition):
    if definition is None:
        return None
    return {
        "preamp_db": float(definition.preamp_db),
        "filters": [
            {
                "source_line": f.source_line,
                "source_number": f.source_number,
                "is_enabled": bool(f.is_enabled),
                "type": f.type.value,
                "frequency_hz": float(f.frequency_hz),
                "gain_db": float(f.gain_db),
                "q": float(f.q),
            }
            for f in definition.filters
        ],
    }


def _unpack_eq_definition(packed):
    if packed is None:
        return None
    return EqualizerDefinition(
        preamp_db=packed["preamp_db"],
        filters=tuple(
            EqualizerFilter(
                source_line=f["source_line"],
                source_number=f["source_number"],
                is_enabled=f["is_enabled"],
                type=FilterType(f["type"]),
                frequency_hz=f["frequency_hz"],
                gain_db=f["gain_db"],
                q=f["q"],
            )
            for f in packed["filters"]
        ),
    )


def _pack_prepared(item):
    if item is None:
        return None
    _, definition, design = item
    preamp, coeffs = design
    return {
        "definition": _pack_eq_definition(definition),
        "design": [float(preamp),
                   [[c.b0, c.b1, c.b2, c.a1, c.a2] for c in coeffs]],
    }


def _unpack_prepared(packed):
    if packed is None:
        return None
    preamp, coeffs = packed["design"]
    return ("prepared", _unpack_eq_definition(packed["definition"]),
            (preamp, [BiquadCoefficients(*c) for c in coeffs]))


_EQ_KEYS = ("active", "transition_from", "pending")


def _pack_eq_runtime(snap: dict) -> dict:
    return {**{k: _pack_prepared(snap[k]) for k in _EQ_KEYS},
            "samples_into_transition": int(snap["samples_into_transition"]),
            "reset_requested": bool(snap["reset_requested"])}


def _unpack_eq_runtime(packed: dict) -> dict:
    return {**{k: _unpack_prepared(packed[k]) for k in _EQ_KEYS},
            "samples_into_transition": packed["samples_into_transition"],
            "reset_requested": packed["reset_requested"]}


# --- the raw container ------------------------------------------------------


def _atomic_finalize(tmp: str, final: str) -> None:
    """fsync, rename, fsync the directory: atomic against a process crash
    and a power loss."""
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, final)
    try:
        dir_fd = os.open(os.path.dirname(final) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:  # pragma: no cover - platform-dependent dir fsync
        pass


def _write_raw(path: str, tree: dict, extra: dict) -> None:
    metas, arrays, base = [], [], 0
    for leaf in _leaves(tree):
        arr = np.ascontiguousarray(leaf)
        base += (-base) % 64
        metas.append({"shape": list(np.shape(leaf)), "dtype": arr.dtype.str,
                      "ext": False, "offset": base, "nbytes": int(arr.nbytes)})
        arrays.append(arr)
        base += arr.nbytes
    header = json.dumps({"treedef": _treedef_repr(tree), "extra": extra,
                         "leaves": metas}).encode()
    final = checkpoint_path(path)
    tmp = final + ".tmp.npz"
    start = len(_RAW_MAGIC) + 8 + len(header)
    payload0 = start + (-start) % 64
    with open(tmp, "wb") as f:
        f.write(_RAW_MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for meta, arr in zip(metas, arrays):
            f.write(b"\x00" * (payload0 + meta["offset"] - f.tell()))
            arr.tofile(f)
    _atomic_finalize(tmp, final)


class _RawReader:
    """Reader of the raw container. Every malformed file raises
    ValueError."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "rb")
        try:
            self._parse_header()
        except BaseException:
            self._f.close()
            raise

    def _parse_header(self) -> None:
        size = os.fstat(self._f.fileno()).st_size
        magic = self._f.read(len(_RAW_MAGIC))
        if magic.startswith(b"PK\x03\x04"):
            raise SnapshotCompatError(
                f"{self.path}: an npz-container checkpoint (the JAX "
                f"package's older container); reading it is not ported "
                f"(ROADMAP Queue 1 item 16). Re-save it with the JAX "
                f"package's save_pool_snapshot, which writes the raw "
                f"container.")
        if magic != _RAW_MAGIC:
            raise ValueError(f"{self.path}: not a raw pool snapshot (magic)")
        hlen = int.from_bytes(self._f.read(8), "little")
        start = len(_RAW_MAGIC) + 8 + hlen
        if hlen <= 0 or start > size:
            raise ValueError(f"{self.path}: truncated snapshot header "
                             f"({hlen} header bytes, file {size} bytes)")
        try:
            header = json.loads(self._f.read(hlen).decode())
        except (UnicodeDecodeError, ValueError) as err:
            raise ValueError(f"{self.path}: unreadable snapshot header: "
                             f"{err}") from err
        leaves = header.get("leaves") if isinstance(header, dict) else None
        if not leaves or not isinstance(leaves, list):
            raise ValueError(f"{self.path}: snapshot header lists no leaves")
        self._payload0 = start + (-start) % 64
        for i, m in enumerate(leaves):
            try:
                shape = tuple(int(d) for d in m["shape"])
                dtype = np.dtype(m["dtype"])
                offset, nbytes = int(m["offset"]), int(m["nbytes"])
            except (KeyError, TypeError, ValueError) as err:
                raise ValueError(f"{self.path}: leaf_{i} header is malformed: "
                                 f"{err}") from err
            if m.get("ext") or nbytes != dtype.itemsize * int(np.prod(shape)):
                raise ValueError(f"{self.path}: leaf_{i} header is malformed")
            if self._payload0 + offset + nbytes > size:
                raise ValueError(
                    f"{self.path}: leaf_{i}: truncated payload (file "
                    f"{size} bytes, leaf ends at "
                    f"{self._payload0 + offset + nbytes})")
            m["shape"], m["dtype"] = shape, dtype
        self.extra = header.get("extra")
        self.treedef_repr = header.get("treedef")
        self.leaves = leaves

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()

    def leaf(self, i: int) -> np.ndarray:
        m = self.leaves[i]
        raw = np.empty(m["nbytes"], np.uint8)
        mv = memoryview(raw)
        pos = self._payload0 + m["offset"]
        done = 0
        while done < m["nbytes"]:
            got = os.preadv(self._f.fileno(),
                            [mv[done:done + _READ_CHUNK]], pos + done)
            if got <= 0:
                raise ValueError(f"{self.path}: leaf_{i}: truncated payload "
                                 f"({done} of {m['nbytes']} bytes)")
            done += got
        return raw.view(m["dtype"]).reshape(m["shape"])


# --- pool snapshots ---------------------------------------------------------


def save_pool_snapshot(path: str, snap: dict) -> None:
    """Persist a StreamPool.snapshot() to ONE file at checkpoint_path(path),
    atomically (temp file, fsync, rename): the carry with its debt, and the
    attached lanes, EQ machine and optional serving resume tokens as JSON
    in the header. A snapshot taken with materialize=False (device copies)
    is fetched to the host here, so a server calls this outside its lock."""
    meta = {
        "schema": POOL_SNAPSHOT_SCHEMA,
        "carry": _carry_format(snap["state"]),
        "attached": [int(s) for s in snap["attached"]],
        "eq_enabled": bool(snap["eq_enabled"]),
        "groups": int(snap.get("groups", 1)),
        "eq_runtime": _pack_eq_runtime(snap["eq_runtime"]),
    }
    if "eq_runtimes" in snap:
        meta["eq_runtimes"] = [_pack_eq_runtime(s)
                               for s in snap["eq_runtimes"]]
    if "resume_tokens" in snap:
        meta["resume_tokens"] = {str(k): str(v)
                                 for k, v in snap["resume_tokens"].items()}
    _write_raw(path, _host_tree(snap["state"], snap["debt"]), meta)


def snapshot_lane_count(path: str) -> int:
    """The lane count (max_streams) a pool snapshot was written at: the
    length of its debt vector, leaf 0, read from the header alone."""
    with _RawReader(checkpoint_path(path)) as data:
        shape = data.leaves[0]["shape"]
    if len(shape) != 1:
        raise ValueError(f"{checkpoint_path(path)}: leaf 0 is not a per-lane "
                         f"vector (shape {shape}): not a pool snapshot")
    return int(shape[0])


def _check_meta(path: str, meta: Any, expected_carry: str) -> None:
    if not isinstance(meta, dict) or "schema" not in meta:
        raise SnapshotCompatError(
            f"{path}: checkpoint predates schema versioning (schema 1, the "
            f"full-window era) and this build reads schema "
            f"{POOL_SNAPSHOT_SCHEMA} only; the migration of such files is "
            f"not ported (ROADMAP Queue 1 item 16). Read it with the build "
            f"that wrote it, or re-create the snapshot.")
    if meta["schema"] != POOL_SNAPSHOT_SCHEMA:
        raise SnapshotCompatError(
            f"{path}: checkpoint schema {meta['schema']} is incompatible "
            f"with this build's schema {POOL_SNAPSHOT_SCHEMA}. Re-create "
            f"the snapshot with this build, or read it with the build that "
            f"wrote it.")
    if meta.get("carry", expected_carry) != expected_carry:
        raise SnapshotCompatError(
            f"{path}: checkpoint carry format {meta['carry']!r} does not "
            f"match this build's {expected_carry!r} at schema "
            f"{POOL_SNAPSHOT_SCHEMA}: the carry layout changed without a "
            f"schema bump; re-create the snapshot with this build.")


def load_pool_snapshot(path: str, pool, lanes: Optional[int] = None) -> dict:
    """Load a persisted pool snapshot (written by this port or the JAX
    package) in StreamPool.restore() form: the carry as the port's
    NamedTuples of numpy arrays, the EQ machine as the port's types, and
    the serving `resume_tokens` when present. `pool` supplies the expected
    structure, checked leaf by leaf (shape and dtype) before any payload is
    read; `lanes=N` checks against the pool's carry at N lanes instead, for
    restore(..., resize=True) (peek N with snapshot_lane_count)."""
    norm = checkpoint_path(path)
    if lanes is not None and lanes == pool.max_streams:
        lanes = None
    like, specs = _expected_leaves(pool, lanes)
    expected_carry = _carry_format(like["state"])
    with _RawReader(norm) as data:
        meta = data.extra
        _check_meta(norm, meta, expected_carry)
        got = [(tuple(m["shape"]), m["dtype"]) for m in data.leaves]
        if data.treedef_repr != _treedef_repr(like) or got != specs:
            raise SnapshotCompatError(
                f"{norm}: checkpoint matches this build's schema "
                f"{POOL_SNAPSHOT_SCHEMA} and carry format but its arrays do "
                f"not fit this pool: the writing pool was constructed "
                f"differently (lanes, block size, IR partitions, tier). A "
                f"size-only difference resizes: load_pool_snapshot(..., "
                f"lanes=snapshot_lane_count(path)) then restore(..., "
                f"resize=True). Saved {data.treedef_repr} {got}, expected "
                f"{_treedef_repr(like)} {specs}")
        tree = _unflatten(like, iter([data.leaf(i) for i in range(len(got))]))
    state = _map_convs(lambda c: c if hasattr(c, "pages") else upols.ConvState(
        fdl=c.fdl, write_pos=np.int32(c.write_pos)), tree["state"])
    try:
        snap = {
            "state": state,
            "debt": tree["debt"],
            "attached": [int(s) for s in meta["attached"]],
            "eq_enabled": bool(meta["eq_enabled"]),
            "groups": int(meta["groups"]),
            "eq_runtime": _unpack_eq_runtime(meta["eq_runtime"]),
        }
        if "eq_runtimes" in meta:
            snap["eq_runtimes"] = [_unpack_eq_runtime(s)
                                   for s in meta["eq_runtimes"]]
        if "resume_tokens" in meta:
            snap["resume_tokens"] = {int(k): str(v) for k, v in
                                     meta["resume_tokens"].items()}
    except (KeyError, TypeError, ValueError) as err:
        raise SnapshotCompatError(f"{norm}: checkpoint metadata is "
                                  f"malformed: {err!r}") from err
    return snap
