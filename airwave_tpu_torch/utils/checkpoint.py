"""Carry checkpoints: save_pytree/load_pytree and the serving pool files.

Port of airwave_tpu/utils/checkpoint.py. A carry (NamedTuples, tuples,
lists and dicts of arrays; torch tensors are fetched to the host) goes to
one file in either of the JAX package's containers, and the files go both
ways between the packages:
  - "npz" (the default of save_pytree): an np.savez archive of leaf_i
    arrays with the structure string, extension dtypes and the extra JSON
    as uint8 entries;
  - "raw" (every serving checkpoint): magic | u64 header length | header
    JSON | 64-byte aligned leaf payloads, read with chunked os.preadv into
    preallocated buffers (the buffered read paths move tens of MB/s on
    virtualized hosts even from page cache).
Loaders dispatch on the file's first bytes. The structure is checked as
JAX renders the same pytree (a small formatter over the port's NamedTuples
and tuples stands in for jax.tree_util), and every leaf's shape and dtype
against the template: a mismatch is an error, never a cast.

Pool snapshots carry the schema number, the carry tag and the per-group EQ
machines (`eq_runtimes`) in the header, and the leaves in JAX's flattening
order (debt, each group's conv leaves, each group's s_from, s_to, counter)
with JAX's dtypes (the ring cursor, a Python int in the port's ConvState,
as a 0-d int32), so a checkpoint written by either package restores the
other's pool of the same construction bit for bit. load_pool_snapshot
reads every generation the JAX package reads: a schema-less one-file
snapshot whose arrays fit loads, a round-3 full-window ring carry is
migrated (ops/upols.migrate_full_window_fdl), anything else raises the
versioned SnapshotCompatError. Every malformed file (bad magic, a header
that does not parse or lists no leaves, a payload or archive cut short)
raises ValueError, so a serving restart can move it aside instead of
crashing.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                      FilterType)
from airwave_tpu_torch.ops import upols
from airwave_tpu_torch.ops.biquad_design import BiquadCoefficients

_RAW_MAGIC = b"AWSNAP1\n"
_READ_CHUNK = 64 << 20  # bytes per preadv

# Serving-checkpoint schema history (the JAX package's):
#   (unversioned, sidecar)  metadata in a .meta.json next to the npz.
#   (unversioned, embedded) the one-file format, written by both carry
#                           generations, so structure decides.
#   2                       the half-window carry this port runs.
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
    """str(jax.tree_util.tree_structure(tree)) for the trees a carry holds:
    dicts (keys sorted), NamedTuples, tuples, lists, None and array
    leaves."""
    return f"PyTreeDef({_node_repr(tree)})"


def _node_repr(node: Any) -> str:
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_node_repr(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        children = ", ".join(_node_repr(c) for c in node)
        return f"CustomNode(namedtuple[{type(node).__name__}], [{children}])"
    if isinstance(node, tuple):
        inner = ", ".join(_node_repr(c) for c in node)
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    if isinstance(node, list):
        return "[" + ", ".join(_node_repr(c) for c in node) + "]"
    return "*"


def _leaves(tree: Any) -> list:
    """The tree's leaves in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
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
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(c, leaves) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, leaves) for c in like)
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


def _host_leaf(leaf) -> np.ndarray:
    """A leaf as a numpy array (a tensor fetched to the host)."""
    if isinstance(leaf, torch.Tensor):
        try:
            return leaf.detach().cpu().numpy()
        except TypeError as err:
            raise ValueError(f"a {leaf.dtype} tensor has no numpy dtype to "
                             f"checkpoint it as: {err}") from err
    return np.asarray(leaf)


def _host_tree(snap_state: Any, debt: Any) -> dict:
    """{"debt", "state"} with every leaf a numpy array of JAX's dtype: the
    ring cursors as 0-d int32, tensors fetched to the host."""
    state = _map_convs(_cursor_leaf, snap_state)
    state = _unflatten(state, iter([_host_leaf(x) for x in _leaves(state)]))
    return {"debt": np.asarray(debt, np.int64), "state": state}


def _leaf_spec(leaf) -> tuple:
    """(shape, numpy dtype) of a template leaf, read from its metadata
    alone: a template may be the pool's live device carry or meta
    tensors, which must not be fetched."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape),
                torch.empty((), dtype=leaf.dtype).numpy().dtype)
    shape, dtype = getattr(leaf, "shape", None), getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        arr = np.asarray(leaf)  # a Python scalar
        shape, dtype = arr.shape, arr.dtype
    return tuple(shape), np.dtype(dtype)


def _expected_tree(pool, lanes: Optional[int]) -> dict:
    """The tree of the pool's carry (at `lanes` lanes) as a snapshot file
    holds it, without moving any carry data."""
    if lanes is None:
        state, debt = pool._state, pool._debt
    else:
        like = pool.state_like(lanes)
        state, debt = like["state"], like["debt"]
    return {"debt": debt, "state": _map_convs(_cursor_leaf, state)}


# --- extension dtypes -------------------------------------------------------


def _is_extension_dtype(dtype: np.dtype) -> bool:
    # Extension dtypes (ml_dtypes bfloat16 and the like) survive np.asarray
    # but np.savez writes them as raw void; the round trip of the dtype's
    # descriptor tells them apart.
    try:
        return np.dtype(dtype.str) != dtype
    except TypeError:
        return True


def _resolve_dtype(name: str) -> np.dtype:
    """The numpy dtype an `__ext_dtypes__` entry names. The port does not
    use ml_dtypes, so a name numpy alone cannot resolve (bfloat16, the
    float8 types) is an error naming it."""
    try:
        return np.dtype(name)
    except TypeError as err:
        raise ValueError(
            f"checkpoint leaf has extension dtype {name!r}, which this "
            f"build cannot represent without ml_dtypes") from err


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


def _write_raw(path: str, tree: Any, extra: Any) -> None:
    metas, arrays, base = [], [], 0
    for leaf in _leaves(tree):
        arr = _host_leaf(leaf)
        shape = list(arr.shape)
        arr = np.ascontiguousarray(arr)
        ext = _is_extension_dtype(arr.dtype)
        base += (-base) % 64
        metas.append({"shape": shape,
                      "dtype": arr.dtype.name if ext else arr.dtype.str,
                      "ext": bool(ext), "offset": base,
                      "nbytes": int(arr.nbytes)})
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


def _is_raw_snapshot(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(_RAW_MAGIC)) == _RAW_MAGIC
    except OSError:
        return False


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
        if self._f.read(len(_RAW_MAGIC)) != _RAW_MAGIC:
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
                offset, nbytes = int(m["offset"]), int(m["nbytes"])
                dtype = (None if m.get("ext") else np.dtype(m["dtype"]))
            except (KeyError, TypeError, ValueError) as err:
                raise ValueError(f"{self.path}: leaf_{i} header is malformed: "
                                 f"{err}") from err
            if dtype is None:
                dtype = _resolve_dtype(str(m["dtype"]))
            if nbytes != dtype.itemsize * int(np.prod(shape)):
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
        if i >= len(self.leaves):
            raise ValueError(f"checkpoint missing leaf_{i}")
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


# --- the npz container ------------------------------------------------------


@contextlib.contextmanager
def _npz(path: str):
    """np.load of an npz archive, with every way a cut or foreign file
    fails (empty, not a zip, a member cut short) raised as ValueError."""
    broken = (EOFError, zipfile.BadZipFile, zlib.error)
    try:
        data = np.load(path)
    except broken as err:
        raise ValueError(f"{path}: unreadable checkpoint: {err!r}") from err
    if not hasattr(data, "files"):
        raise ValueError(f"{path}: an .npy array, not a checkpoint archive")
    try:
        yield data
    except broken as err:
        raise ValueError(f"{path}: unreadable checkpoint: {err!r}") from err
    finally:
        data.close()


def _npz_json(data, key: str) -> Any:
    return json.loads(bytes(data[key]).decode()) if key in data else None


# --- save_pytree / load_pytree ----------------------------------------------


def save_pytree(path: str, tree: Any, extra_json: Any = None,
                container: str = "npz") -> None:
    """Atomically persist a carry of arrays (numpy arrays, tensors, Python
    scalars in NamedTuples, tuples, lists and dicts) to
    checkpoint_path(path): written to a temp name, fsynced and renamed, so
    a crash mid-write never tears an existing checkpoint. `extra_json`
    (JSON-serialisable) rides inside the same file; read it back with
    load_pytree_extra or load_pytree(with_extra=True).

    container="raw" writes the raw large-transfer layout instead of the npz
    archive (no CRC pass on load, per-leaf offsets); the loaders read
    either. The files are the JAX package's, leaf for leaf."""
    if container == "raw":
        _write_raw(path, tree, extra_json)
        return
    arrays, ext_dtypes = {}, {}
    for i, leaf in enumerate(_leaves(tree)):
        arr = _host_leaf(leaf)
        key = f"leaf_{i}"
        if _is_extension_dtype(arr.dtype):
            # Raw bytes and the true dtype: np.savez would write void.
            ext_dtypes[key] = {"dtype": arr.dtype.name, "shape": arr.shape}
            arr = np.frombuffer(arr.tobytes(), dtype=np.uint8)
        arrays[key] = arr
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(_treedef_repr(tree)).encode(), dtype=np.uint8)
    if ext_dtypes:
        arrays["__ext_dtypes__"] = np.frombuffer(
            json.dumps(ext_dtypes).encode(), dtype=np.uint8)
    if extra_json is not None:
        arrays["__extra__"] = np.frombuffer(
            json.dumps(extra_json).encode(), dtype=np.uint8)
    final = checkpoint_path(path)
    tmp = final + ".tmp.npz"  # keeps the suffix, so savez appends nothing
    np.savez(tmp, **arrays)
    _atomic_finalize(tmp, final)


def load_pytree_extra(path: str) -> Any:
    """save_pytree's `extra_json` payload (None if absent)."""
    norm = checkpoint_path(path)
    if _is_raw_snapshot(norm):
        with _RawReader(norm) as data:
            return data.extra
    with _npz(norm) as data:
        return _npz_json(data, "__extra__")


def _check_structure(saved: Any, like: Any) -> None:
    if saved is not None and saved != _treedef_repr(like):
        raise ValueError(f"checkpoint structure mismatch: saved {saved!r} "
                         f"!= expected {_treedef_repr(like)!r}")


def _check_leaf_matches(i: int, shape: tuple, dtype: np.dtype,
                        ref: Any) -> None:
    """A stored leaf's shape and dtype against the template's metadata."""
    want_shape, want_dtype = _leaf_spec(ref)
    if tuple(shape) != want_shape:
        raise ValueError(f"leaf_{i}: shape {tuple(shape)} != expected "
                         f"{want_shape}")
    if dtype != want_dtype:
        raise ValueError(f"leaf_{i}: dtype {dtype} != expected {want_dtype}")


def load_pytree(path: str, like: Any, with_extra: bool = False,
                extra_check=None) -> Any:
    """Restore a carry saved by save_pytree (by either package, in either
    container) into the structure of `like`, as numpy arrays.

    The stored structure and every leaf's shape and dtype must match
    `like` exactly (only `like`'s metadata is read, so it may be a device
    carry). with_extra=True returns (tree, extra_json or None).
    `extra_check(extra or None)` runs before any structure or leaf check,
    the hook a schema-versioned format uses to fail with its own error."""
    norm = checkpoint_path(path)
    refs = _leaves(like)
    if _is_raw_snapshot(norm):
        with _RawReader(norm) as data:
            extra = data.extra
            if extra_check is not None:
                extra_check(extra)
            _check_structure(data.treedef_repr, like)
            # Every leaf is checked from the header before any payload is
            # read: a multi-GB file that does not fit fails at once.
            for i, ref in enumerate(refs):
                if i >= len(data.leaves):
                    raise ValueError(f"checkpoint missing leaf_{i}")
                m = data.leaves[i]
                _check_leaf_matches(i, m["shape"], m["dtype"], ref)
            leaves = [data.leaf(i) for i in range(len(refs))]
    else:
        with _npz(norm) as data:
            extra = _npz_json(data, "__extra__")
            if extra_check is not None:
                extra_check(extra)
            _check_structure(_npz_json(data, "__treedef__"), like)
            ext_dtypes = _npz_json(data, "__ext_dtypes__") or {}
            leaves = []
            for i, ref in enumerate(refs):
                key = f"leaf_{i}"
                if key not in data:
                    raise ValueError(f"checkpoint missing {key}")
                loaded = data[key]
                if key in ext_dtypes:
                    meta = ext_dtypes[key]
                    loaded = np.frombuffer(
                        loaded.tobytes(), dtype=_resolve_dtype(meta["dtype"])
                    ).reshape(tuple(meta["shape"]))
                _check_leaf_matches(i, loaded.shape, loaded.dtype, ref)
                leaves.append(loaded)
    tree = _unflatten(like, iter(leaves))
    return (tree, extra) if with_extra else tree


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


# --- pool snapshots ---------------------------------------------------------


def save_pool_snapshot(path: str, snap: dict) -> None:
    """Persist a StreamPool.snapshot() to ONE file at checkpoint_path(path),
    atomically, in the raw container: the carry with its debt, and the
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
    save_pytree(path, _host_tree(snap["state"], snap["debt"]),
                extra_json=meta, container="raw")


def snapshot_lane_count(path: str) -> int:
    """The lane count (max_streams) a pool snapshot was written at: the
    length of its debt vector, leaf 0 in either container, read without
    loading the carry."""
    norm = checkpoint_path(path)
    if _is_raw_snapshot(norm):
        with _RawReader(norm) as data:
            shape = data.leaves[0]["shape"]
    else:
        with _npz(norm) as data:
            if "leaf_0" not in data:
                raise ValueError(f"{norm}: not a pool snapshot (no leaf_0)")
            shape = data["leaf_0"].shape
    if len(shape) != 1:
        raise ValueError(f"{norm}: leaf 0 is not a per-lane vector (shape "
                         f"{shape}): not a pool snapshot")
    return int(shape[0])


def _snapshot_from(path: str, state: Any, debt: np.ndarray, meta: Any,
                   **more) -> dict:
    """The StreamPool.restore() dict from a loaded carry and its header
    metadata (the port's EQ types)."""
    try:
        snap = {
            "state": _map_convs(lambda c: c if hasattr(c, "pages") else
                                upols.ConvState(fdl=c.fdl,
                                                write_pos=np.int32(c.write_pos)),
                                state),
            "debt": debt,
            "attached": [int(s) for s in meta["attached"]],
            "eq_enabled": bool(meta["eq_enabled"]),
            "groups": int(meta["groups"]),
            "eq_runtime": _unpack_eq_runtime(meta["eq_runtime"]),
            **more,
        }
        if "eq_runtimes" in meta:
            snap["eq_runtimes"] = [_unpack_eq_runtime(s)
                                   for s in meta["eq_runtimes"]]
        if "resume_tokens" in meta:
            snap["resume_tokens"] = {int(k): str(v) for k, v in
                                     meta["resume_tokens"].items()}
    except (KeyError, TypeError, ValueError) as err:
        raise SnapshotCompatError(f"{path}: checkpoint metadata is "
                                  f"malformed: {err!r}") from err
    return snap


# The round-3 full-window conv carry as its files name it: JAX renders a
# NamedTuple by its class name, so this shim's name and field order match
# the structure string those files hold.
_LegacyConvState = collections.namedtuple(
    "ConvState", ["fdl", "overlap", "write_pos"])


def _migrate_full_window_snapshot(path: str, pool, like: dict):
    """Read `path` as a round-3 FULL-window pool snapshot and convert it to
    the half-window carry (upols.migrate_full_window_fdl). Returns the
    StreamPool.restore() dict, or None when the file does not have the
    full-window layout (the caller raises the versioned error)."""
    if getattr(pool, "blocks_per_step", 1) != 1:
        return None  # a paged carry has no migration path
    T = int(pool.block_size)

    def conv_to_legacy(conv):
        shape = tuple(getattr(conv, "fdl", np.zeros(0)).shape)
        if len(shape) != 5:
            raise ValueError("not a single-block conv carry")
        kp, S, p2, c, B = shape
        if p2 < 2 or c != 2:
            raise ValueError("unexpected conv carry shape")
        return _LegacyConvState(
            fdl=np.zeros((kp, S, p2 - 1, c, B), np.float32),
            overlap=np.zeros((B, S, T), np.float32),
            write_pos=np.zeros((), np.int32))

    state_new = like["state"]
    conv_new = state_new.conv
    grouped = type(conv_new) is tuple
    try:
        legacy_conv = (tuple(conv_to_legacy(c) for c in conv_new)
                       if grouped else conv_to_legacy(conv_new))
        like_old = {"state": state_new._replace(conv=legacy_conv),
                    "debt": like["debt"]}
        data, meta = load_pytree(path, like_old, with_extra=True)
    except (ValueError, KeyError):
        return None
    # A schema-less file without the control metadata this build restores
    # is older than the round-3 one-file format: the versioned error.
    if not isinstance(meta, dict) or not (
            {"attached", "eq_enabled", "groups", "eq_runtime"} <= meta.keys()):
        return None

    debt = np.asarray(data["debt"], np.int64)
    convs_old = data["state"].conv if grouped else (data["state"].conv,)
    lanes_per_group = debt.shape[0] // max(1, len(convs_old))

    def convert(conv, g):
        d = debt[g * lanes_per_group:(g + 1) * lanes_per_group]
        return upols.ConvState(
            fdl=upols.migrate_full_window_fdl(
                conv.fdl, conv.overlap, int(conv.write_pos), d),
            write_pos=np.asarray(conv.write_pos, np.int32))

    converted = tuple(convert(c, g) for g, c in enumerate(convs_old))
    state = data["state"]._replace(conv=converted if grouped else converted[0])
    return _snapshot_from(path, state, np.zeros_like(debt), meta,
                          migrated_from="full-window (schema 1)")


def load_pool_snapshot(path: str, pool, lanes: Optional[int] = None) -> dict:
    """Load a persisted pool snapshot (written by this port or the JAX
    package, in either container) in StreamPool.restore() form: the carry
    as the port's NamedTuples of numpy arrays, the EQ machine as the port's
    types, and the serving `resume_tokens` when present. `pool` supplies
    the expected structure, checked leaf by leaf (shape and dtype) before
    the carry is used; `lanes=N` checks against the pool's carry at N lanes
    instead, for restore(..., resize=True) (peek N with
    snapshot_lane_count).

    The schema is checked first, so a file of another format generation
    fails with the versioned SnapshotCompatError naming both schemas. A
    schema-less one-file snapshot (both carry generations wrote that
    format) is decided by its arrays: it loads if they fit, a round-3
    full-window ring carry is migrated (the result has "migrated_from";
    its debt is repaid inside the migration), anything else raises the
    versioned error. Such files load only at the size they were written."""
    norm = checkpoint_path(path)
    if lanes is not None and lanes == pool.max_streams:
        lanes = None
    like = _expected_tree(pool, lanes)
    expected_carry = _carry_format(like["state"])
    seen = {}

    def schema_check(meta):
        seen["meta"] = meta
        if meta is None:
            # Sidecar era: the control metadata is not in the file, so it
            # cannot be restored even where the arrays fit.
            raise SnapshotCompatError(
                f"{norm}: checkpoint schema 1 (sidecar "
                "layout, full-window era) is incompatible with schema "
                f"{POOL_SNAPSHOT_SCHEMA}. Re-create the snapshot with "
                "this build, or read it with the build that wrote it.")
        if not isinstance(meta, dict):
            raise SnapshotCompatError(f"{norm}: checkpoint metadata is "
                                      f"malformed: {meta!r}")
        if "schema" not in meta:
            return  # the pre-versioning one-file format: structure decides
        if meta["schema"] != POOL_SNAPSHOT_SCHEMA:
            raise SnapshotCompatError(
                f"{norm}: checkpoint schema "
                f"{meta['schema']} is incompatible with this build's "
                f"schema {POOL_SNAPSHOT_SCHEMA}. Re-create the snapshot "
                "with this build, or read it with the build that wrote "
                "it.")
        if meta.get("carry", expected_carry) != expected_carry:
            raise SnapshotCompatError(
                f"{norm}: checkpoint carry format "
                f"{meta['carry']!r} does not match this build's "
                f"{expected_carry!r} at schema {POOL_SNAPSHOT_SCHEMA} — "
                "the carry layout changed without a schema bump; treat "
                "as an incompatible upgrade (re-create the snapshot "
                "with this build).")

    # The messages are the JAX package's, word for word.
    try:
        data, meta = load_pytree(norm, like, with_extra=True,
                                 extra_check=schema_check)
    except SnapshotCompatError:
        raise
    except ValueError as exc:
        if "meta" not in seen:
            raise  # the file itself is unreadable
        meta = seen["meta"]
        if "schema" not in meta and lanes is not None:
            raise SnapshotCompatError(
                f"{norm}: pre-versioning snapshots "
                "cannot be loaded at a different lane count — load it "
                "at the size it was written (the round-3 full-window "
                "migration applies there), re-save, then resize."
            ) from exc
        if "schema" not in meta:
            migrated = _migrate_full_window_snapshot(norm, pool, like)
            if migrated is not None:
                return migrated
            raise SnapshotCompatError(
                f"{norm}: checkpoint predates schema "
                "versioning and its carry neither matches this build "
                "nor fits the round-3 full-window layout this build "
                "can migrate — schema 1 vs this build's schema "
                f"{POOL_SNAPSHOT_SCHEMA} (half-window carry). Re-create "
                "the snapshot with this build, or read it with the "
                f"build that wrote it. (Underlying mismatch: {exc})"
            ) from exc
        raise SnapshotCompatError(
            f"{norm}: checkpoint matches this build's "
            f"schema {POOL_SNAPSHOT_SCHEMA} and carry format but its "
            "arrays do not fit this pool — the writing pool was "
            "constructed differently (lanes, block size, IR partitions, "
            "profile groups), or the carry layout changed without a "
            "schema bump. Load it with an identically-constructed pool "
            "(a size-only difference resizes: load_pool_snapshot(..., "
            "lanes=snapshot_lane_count(path)) then restore(..., "
            f"resize=True)), or re-create the snapshot. "
            f"(Underlying mismatch: {exc})"
        ) from exc
    return _snapshot_from(norm, data["state"], data["debt"], meta)
