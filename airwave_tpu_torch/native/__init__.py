"""Native host data plane: the ragged per-stream frame assembler.

Port of airwave_tpu/native. assembler.cc (the same C++ source as the JAX
package's) is compiled with g++ at first use into native/_build/ next to
this file, keyed on the source's hash, the compiler's version and the
flags, and loaded with ctypes. Unlike the JAX package nothing falls back
silently: RaggedAssembler takes impl="native" (the serving pool's, which
raises AssemblerBuildError when the library cannot be built or bound) or
impl="numpy" (the NumPy implementation of the same contract, for tests).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "assembler.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class AssemblerBuildError(RuntimeError):
    """assembler.cc could not be compiled or its library not bound."""


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    vp, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "awv_create": (vp, [i, i, i, i]),
        "awv_destroy": (None, [vp]),
        "awv_push": (i, [vp, i, f32p, i]),
        "awv_push_many": (i, [vp, i, i32p, f32p, i]),
        "awv_pending": (i, [vp, i]),
        "awv_ready_count": (i, [vp]),
        "awv_harvest_allowed_n": (i, [vp, i, i, i32p, i32p, f32p]),
        "awv_out_free_all": (i, [vp, i32p]),
        "awv_scatter_out_n": (i, [vp, i, i, i32p, f32p]),
        "awv_push_out": (i, [vp, i, f32p, i]),
        "awv_pop_out": (i, [vp, i, f32p, i]),
        "awv_pop_out_many": (i, [vp, i, i32p, f32p, i]),
        "awv_out_available": (i, [vp, i]),
        "awv_reset_stream": (i, [vp, i]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source, compiler and flags) and bind the library."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise AssemblerBuildError(
            "g++ not found on PATH: the native assembler is built from "
            f"{SOURCE.name} at first use")
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    key = hashlib.sha256(SOURCE.read_bytes() + version.encode()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"assembler-{key}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build under a private name and rename: concurrent first uses in
        # several processes never load a half-written library.
        tmp = BUILD_DIR / f"{path.name}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise AssemblerBuildError(
                f"g++ failed on {SOURCE} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(str(path))
        _declare(lib)
    except (OSError, AttributeError) as err:
        raise AssemblerBuildError(f"cannot bind {path}: {err}") from err
    return lib


def _f32(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class RaggedAssembler:
    """Per-stream ragged ingest -> dense batches -> per-stream drain.

    push(stream, [C, n]) buffers input; harvest_allowed(max_batch, allow)
    pops one step from every step-complete allowed stream as (indices [k],
    blocks [k, C, frames]); scatter(indices, blocks) queues rendered output;
    pop(stream, n) drains with zero-fill on underflow (the reference
    adapter's latency contract).

    impl="native" runs the C++ rings (and raises AssemblerBuildError if the
    library cannot be built); impl="numpy" runs the NumPy implementation of
    the same contract."""

    def __init__(self, n_streams: int, channels: int, block: int,
                 capacity: Optional[int] = None,
                 impl: str = "native") -> None:
        if impl not in ("native", "numpy"):
            raise ValueError(f"impl={impl!r}: expected 'native' or 'numpy'")
        self.n_streams = n_streams
        self.channels = channels
        self.block = block
        self.capacity = capacity or (block * 16)
        self.impl = impl
        self._lib = None
        self._handle = None
        if impl == "native":
            self._lib = load_library()
            handle = self._lib.awv_create(n_streams, channels, block,
                                          self.capacity)
            if not handle:
                raise ValueError(
                    f"awv_create refused n_streams={n_streams} channels="
                    f"{channels} block={block} capacity={self.capacity}")
            self._handle = ctypes.c_void_p(handle)
        else:
            self._py_in = [np.zeros((channels, 0), np.float32)
                           for _ in range(n_streams)]
            self._py_out = [np.zeros((channels, 0), np.float32)
                            for _ in range(n_streams)]

    def close(self) -> None:
        """Free the native rings (idempotent)."""
        if self._handle is not None:
            self._lib.awv_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()

    @property
    def is_native(self) -> bool:
        return self.impl == "native"

    # --- input side ------------------------------------------------------

    def push(self, stream: int, chunk: np.ndarray) -> None:
        chunk = np.ascontiguousarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[0] != self.channels:
            raise ValueError(f"chunk {chunk.shape}: expected "
                             f"[{self.channels}, n]")
        if self.is_native:
            rc = self._lib.awv_push(self._handle, stream, _f32(chunk),
                                    chunk.shape[1])
            if rc == -1:
                raise OverflowError(f"stream {stream} input ring full")
            if rc != 0:
                raise ValueError(f"push failed ({rc})")
            return
        if self._py_in[stream].shape[1] + chunk.shape[1] > self.capacity:
            raise OverflowError(f"stream {stream} input ring full")
        self._py_in[stream] = np.concatenate([self._py_in[stream], chunk],
                                             axis=1)

    def push_many(self, streams, chunks: np.ndarray) -> None:
        """Push chunks [k, C, n] onto k streams in one call, all or nothing:
        if ANY ring lacks space nothing is written and OverflowError
        raises."""
        streams = np.ascontiguousarray(streams, np.int32)
        chunks = np.ascontiguousarray(chunks, np.float32)
        if (chunks.ndim != 3 or chunks.shape[0] != len(streams)
                or chunks.shape[1] != self.channels):
            raise ValueError(f"chunks {chunks.shape}: expected "
                             f"[{len(streams)}, {self.channels}, n]")
        # Validate ids before the zero-length no-op so stale ids are
        # rejected whatever the payload size.
        if np.any((streams < 0) | (streams >= self.n_streams)):
            raise ValueError("stream id out of range")
        if len(streams) == 0 or chunks.shape[2] == 0:
            return
        if self.is_native:
            rc = self._lib.awv_push_many(self._handle, len(streams),
                                         _i32(streams), _f32(chunks),
                                         chunks.shape[2])
            if rc == -1:
                raise OverflowError("an input ring is full (nothing pushed)")
            if rc != 0:
                raise ValueError(f"push_many failed ({rc})")
            return
        extra = {}
        for s in (int(v) for v in streams):
            if (self._py_in[s].shape[1] + extra.get(s, 0) + chunks.shape[2]
                    > self.capacity):
                raise OverflowError("an input ring is full (nothing pushed)")
            extra[s] = extra.get(s, 0) + chunks.shape[2]
        for j, s in enumerate(int(v) for v in streams):
            self._py_in[s] = np.concatenate([self._py_in[s], chunks[j]],
                                            axis=1)

    def pending(self, stream: int) -> int:
        if self.is_native:
            return self._lib.awv_pending(self._handle, stream)
        return self._py_in[stream].shape[1]

    def ready_count(self) -> int:
        """Streams holding at least one block of input."""
        if self.is_native:
            return self._lib.awv_ready_count(self._handle)
        return sum(1 for buf in self._py_in if buf.shape[1] >= self.block)

    def harvest_allowed(self, max_batch: int, allow: np.ndarray,
                        frames: int = 0, out: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Pop `frames` (default one block) from every stream, lowest id
        first, up to max_batch, that has allow[stream] truthy and that many
        frames buffered. Returns (indices [k] int32, blocks [k, C, frames]).

        `out`, a C-contiguous float32 array of at least [max_batch, C,
        frames], receives the blocks in place of a new array (the pool
        harvests straight into its upload staging buffer)."""
        frames = frames or self.block
        allow = np.ascontiguousarray(allow, np.int32)
        if allow.shape != (self.n_streams,):
            raise ValueError(f"allow {allow.shape}: expected "
                             f"({self.n_streams},)")
        if out is None:
            out = np.zeros((max_batch, self.channels, frames), np.float32)
        elif (out.dtype != np.float32 or not out.flags.c_contiguous
              or out.shape[0] < max_batch
              or out.shape[1:] != (self.channels, frames)):
            raise ValueError(f"out {out.dtype} {out.shape}: expected "
                             f"C-contiguous float32 [>={max_batch}, "
                             f"{self.channels}, {frames}]")
        indices = np.zeros(max_batch, np.int32)
        if self.is_native:
            k = self._lib.awv_harvest_allowed_n(
                self._handle, max_batch, frames, _i32(allow), _i32(indices),
                _f32(out))
            if k < 0:
                raise ValueError(f"harvest failed ({k})")
        else:
            k = 0
            for i in range(self.n_streams):
                if k >= max_batch:
                    break
                if allow[i] and self._py_in[i].shape[1] >= frames:
                    out[k] = self._py_in[i][:, :frames]
                    self._py_in[i] = self._py_in[i][:, frames:]
                    indices[k] = i
                    k += 1
        return indices[:k], out[:k]

    # --- output side -----------------------------------------------------

    def out_free_all(self) -> np.ndarray:
        """Per-stream output-ring free space [n_streams] in one call."""
        if self.is_native:
            out = np.zeros(self.n_streams, np.int32)
            self._lib.awv_out_free_all(self._handle, _i32(out))
            return out
        return np.array([self.capacity - buf.shape[1] for buf in self._py_out],
                        np.int32)

    def scatter(self, indices: np.ndarray, blocks: np.ndarray) -> None:
        """Queue rendered frames blocks [k, C, n] per stream, all or
        nothing: an OverflowError means NO ring was modified."""
        indices = np.ascontiguousarray(indices, np.int32)
        blocks = np.ascontiguousarray(blocks, np.float32)
        if (blocks.ndim != 3 or blocks.shape[0] != len(indices)
                or blocks.shape[1] != self.channels):
            raise ValueError(f"blocks {blocks.shape}: expected "
                             f"[{len(indices)}, {self.channels}, n]")
        frames = blocks.shape[2]
        if len(indices) == 0 or frames == 0:
            return
        if self.is_native:
            rc = self._lib.awv_scatter_out_n(self._handle, len(indices),
                                             frames, _i32(indices),
                                             _f32(blocks))
            if rc == -1:
                raise OverflowError("output ring full")
            if rc != 0:
                raise ValueError(f"scatter failed ({rc})")
            return
        extra = {}
        for stream in (int(s) for s in indices):
            if (self._py_out[stream].shape[1] + extra.get(stream, 0)
                    + frames > self.capacity):
                raise OverflowError("output ring full")
            extra[stream] = extra.get(stream, 0) + frames
        for j, stream in enumerate(indices):
            self._py_out[stream] = np.concatenate(
                [self._py_out[stream], blocks[j]], axis=1)

    def try_push_out(self, stream: int, chunk: np.ndarray) -> bool:
        """Queue rendered output for one stream; False when the ring lacks
        space (no partial write: the caller keeps the chunk)."""
        chunk = np.ascontiguousarray(chunk, np.float32)
        if self.is_native:
            rc = self._lib.awv_push_out(self._handle, stream, _f32(chunk),
                                        chunk.shape[1])
            if rc == -1:
                return False
            if rc != 0:
                raise ValueError(f"push_out failed ({rc})")
            return True
        if self._py_out[stream].shape[1] + chunk.shape[1] > self.capacity:
            return False
        self._py_out[stream] = np.concatenate([self._py_out[stream], chunk],
                                              axis=1)
        return True

    def pop(self, stream: int, frames: int) -> np.ndarray:
        out = np.zeros((self.channels, frames), np.float32)
        if self.is_native:
            self._lib.awv_pop_out(self._handle, stream, _f32(out), frames)
            return out
        buf = self._py_out[stream]
        available = min(frames, buf.shape[1])
        out[:, :available] = buf[:, :available]
        self._py_out[stream] = buf[:, available:]
        return out

    def pop_many(self, streams, frames: int) -> np.ndarray:
        """Drain k streams into one [k, C, frames] array (zero-filled per
        stream on underflow)."""
        streams = np.ascontiguousarray(streams, np.int32)
        if np.any((streams < 0) | (streams >= self.n_streams)):
            raise ValueError("stream id out of range")
        out = np.zeros((len(streams), self.channels, frames), np.float32)
        if len(streams) == 0 or frames == 0:
            return out
        if self.is_native:
            rc = self._lib.awv_pop_out_many(self._handle, len(streams),
                                            _i32(streams), _f32(out), frames)
            if rc != 0:
                raise ValueError(f"pop_many failed ({rc})")
            return out
        for j, s in enumerate(int(v) for v in streams):
            buf = self._py_out[s]
            available = min(frames, buf.shape[1])
            out[j, :, :available] = buf[:, :available]
            self._py_out[s] = buf[:, available:]
        return out

    def out_available(self, stream: int) -> int:
        if self.is_native:
            return self._lib.awv_out_available(self._handle, stream)
        return self._py_out[stream].shape[1]

    def reset_stream(self, stream: int) -> None:
        if self.is_native:
            self._lib.awv_reset_stream(self._handle, stream)
            return
        self._py_in[stream] = np.zeros((self.channels, 0), np.float32)
        self._py_out[stream] = np.zeros((self.channels, 0), np.float32)
