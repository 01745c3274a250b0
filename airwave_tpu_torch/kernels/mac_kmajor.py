"""The UPOLS delay-line MAC: hand-written CUDA kernel and its plain version.

    Y[o, k, b] = sum_r fdl[k, r, b] * h[k, o, r]      fdl [K, R, B], h [K, O, R]

Port of the Pallas TPU kernel airwave_tpu/kernels/mac_kmajor.py:mac_kmajor.
The kernel (csrc/mac_kmajor.cu) is memory-bound: it streams the delay line
from device memory once, with the batch on the coalesced axis, and
accumulates in exact fp32 FMAs (the .cu file says how).

Dispatch is by the tensor's device alone: on a CUDA tensor `mac_kmajor`
launches the kernel or raises; on a CPU tensor it runs `mac_kmajor_ref`,
the plain PyTorch version the tests hold the kernel against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from airwave_tpu_torch.kernels import _build

SOURCE = "mac_kmajor.cu"
_MAX_SMEM_BYTES = 48 * 1024  # h[k] staged per CTA without opt-in smem
_MAX_GRID_Y = 65535          # one grid row per bin

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last reset_launch_count()."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def mac_kmajor_ref(fdl: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [K, R, B] x [K, O, R] -> [O, K, B]."""
    return torch.einsum("krb,kor->okb", fdl, h)


@functools.lru_cache(maxsize=None)
def _library():
    lib, log = _build.load(SOURCE)
    fn = lib.airwave_mac_kmajor
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.airwave_cuda_error_string.argtypes = [ctypes.c_int]
    lib.airwave_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


def build() -> str:
    """Build (or load) the kernel library; returns nvcc's log of this build."""
    return _library()[1]


def _check(fdl, h, out, accumulate):
    if fdl.dim() != 3 or h.dim() != 3:
        raise ValueError(f"fdl [K,R,B] and h [K,O,R] expected, got "
                         f"{tuple(fdl.shape)} and {tuple(h.shape)}")
    K, R, B = fdl.shape
    O = h.shape[1]
    if h.shape != (K, O, R):
        raise ValueError(f"h {tuple(h.shape)} does not match fdl "
                         f"{tuple(fdl.shape)}: expected [{K}, O, {R}]")
    tensors = [fdl, h]
    if out is not None:
        if out.shape != (O, K, B):
            raise ValueError(f"out {tuple(out.shape)}: expected [{O}, {K}, {B}]")
        tensors.append(out)
    elif accumulate:
        raise ValueError("accumulate=True needs out")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"float32 expected, got {t.dtype}")
        if t.device != fdl.device:
            raise ValueError(f"tensors on {fdl.device} and {t.device}")
    return K, R, B, O


def mac_kmajor(fdl: torch.Tensor, h: torch.Tensor,
               out: "torch.Tensor | None" = None,
               accumulate: bool = False) -> torch.Tensor:
    """fdl [K, R, B], h [K, O, R] -> [O, K, B], all float32.

    With `out` the result is written there; with accumulate=True it is
    added to what `out` holds (the paged step sums its pages this way)."""
    K, R, B, O = _check(fdl, h, out, accumulate)
    if fdl.device.type == "cpu":
        y = mac_kmajor_ref(fdl, h)
        if out is None:
            return y.contiguous()  # the kernel's layout, which callers view
        return out.add_(y) if accumulate else out.copy_(y)
    if fdl.device.type != "cuda":
        raise ValueError(f"unsupported device {fdl.device}")
    if out is None:
        out = torch.empty((O, K, B), dtype=torch.float32, device=fdl.device)
    for name, t in (("fdl", fdl), ("h", h), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if O * R * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"h[k] of {O}x{R} floats exceeds the kernel's "
                         f"{_MAX_SMEM_BYTES} B of shared memory")
    if not (0 < K <= _MAX_GRID_Y and B > 0 and R > 0 and O > 0):
        raise ValueError(f"unsupported shape K={K} R={R} B={B} O={O}")
    lib, _ = _library()
    stream = torch.cuda.current_stream(fdl.device).cuda_stream
    code = lib.airwave_mac_kmajor(
        fdl.data_ptr(), h.data_ptr(), out.data_ptr(), K, R, B, O,
        int(accumulate), fdl.device.index or 0, stream,
    )
    if code != 0:
        msg = lib.airwave_cuda_error_string(code).decode()
        raise RuntimeError(f"mac_kmajor launch failed: {msg} (cuda error {code})")
    global _launches
    _launches += 1
    return out
