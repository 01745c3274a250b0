"""The UPOLS delay-line MAC: hand-written CUDA kernels and their plain versions.

    Y[o, k, b] = sum_r fdl[k, r, b] * h[k, o, r]      fdl [K, R, B], h [K, O, R]

Port of the Pallas TPU kernel airwave_tpu/kernels/mac_kmajor.py:mac_kmajor.
`mac_kmajor` is the single-block contraction; `mac_kmajor_pages` sums it
over the n pages of the paged delay line in one launch,

    Y[o, k, b] = sum_a sum_r page_a[k, r, b] * bank[a, k, o, r],

the paged step's _paged_mac. Both kernels (csrc/mac_kmajor.cu, one build)
are memory-bound: they stream the delay line from device memory once, with
the batch on the coalesced axis, and accumulate in exact fp32 FMAs (the .cu
file says how).

Dispatch is by the tensor's device alone: on a CUDA tensor a wrapper
launches its kernel or raises; on a CPU tensor it runs the plain PyTorch
version (`mac_kmajor_ref`, `mac_kmajor_pages_ref`) the tests hold the
kernel against.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from airwave_tpu_torch.kernels import _build

SOURCE = "mac_kmajor.cu"
_MAX_SMEM_BYTES = 48 * 1024  # h[k] staged per CTA without opt-in smem
_MAX_GRID_Y = 65535          # one grid row per bin
MAX_PAGES = 32               # page pointers mac_kmajor_pages passes by value
PAGES_COLUMNS = (16, 32, 48, 64)  # mac_kmajor_pages' columns per pass

_launches = {"mac_kmajor": 0, "mac_kmajor_pages": 0}
_launches_by_columns: Counter = Counter()  # (kernel, O) -> launches


def launch_count(kernel: str = "mac_kmajor",
                 columns: "int | None" = None) -> int:
    """Launches of `kernel` since the last reset_launch_count(); with
    `columns`, only its launches at that output width O (a hot-swap round
    doubles the steady O)."""
    if columns is None:
        return _launches[kernel]
    return _launches_by_columns[kernel, columns]


def reset_launch_count() -> None:
    """Set every kernel's launch counts to 0."""
    for name in _launches:
        _launches[name] = 0
    _launches_by_columns.clear()


def mac_kmajor_ref(fdl: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [K, R, B] x [K, O, R] -> [O, K, B]."""
    return torch.einsum("krb,kor->okb", fdl, h)


def mac_kmajor_pages_ref(pages, bank: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the paged MAC: the page-ordered sum of
    mac_kmajor_ref terms, pages n x [K, R, B], bank [n, K, O, R] -> [O, K, B]."""
    acc = mac_kmajor_ref(pages[0], bank[0])
    for page, h in zip(pages[1:], bank[1:]):
        acc = acc + mac_kmajor_ref(page, h)
    return acc


@functools.lru_cache(maxsize=None)
def _library():
    lib, log = _build.load(SOURCE)
    fn = lib.airwave_mac_kmajor
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.airwave_mac_kmajor_pages
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.airwave_cuda_error_string.argtypes = [ctypes.c_int]
    lib.airwave_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


def build() -> str:
    """Build (or load) the kernels' library; returns nvcc's log of this build."""
    return _library()[1]


def max_columns(R: int) -> int:
    """The most output columns O whose h[k] ([O, R] floats) mac_kmajor
    stages in its shared memory."""
    return _MAX_SMEM_BYTES // (4 * int(R))


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
    _check_dtype_device(tensors)
    return K, R, B, O


def _check_dtype_device(tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"float32 expected, got {t.dtype}")
        if t.device != tensors[0].device:
            raise ValueError(f"tensors on {tensors[0].device} and {t.device}")


def _check_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_launch(lib, code, name, O):
    if code != 0:
        msg = lib.airwave_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cuda error {code})")
    _launches[name] += 1
    _launches_by_columns[name, O] += 1


def mac_kmajor(fdl: torch.Tensor, h: torch.Tensor,
               out: "torch.Tensor | None" = None,
               accumulate: bool = False, *, generic: bool = False
               ) -> torch.Tensor:
    """fdl [K, R, B], h [K, O, R] -> [O, K, B], all float32.

    With `out` the result is written there; with accumulate=True it is
    added to what `out` holds (one launch per page summing pages this way
    is what mac_kmajor_pages replaces, and its baseline on the card).
    generic=True runs the any-O kernel in place of an O-specific instance
    (the A/B baseline of the dispatch; the results are bit for bit the
    same)."""
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
    _check_contiguous(fdl=fdl, h=h, out=out)
    if O * R * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"h[k] of {O}x{R} floats exceeds the kernel's "
                         f"{_MAX_SMEM_BYTES} B of shared memory")
    if not (0 < K <= _MAX_GRID_Y and B > 0 and R > 0 and O > 0):
        raise ValueError(f"unsupported shape K={K} R={R} B={B} O={O}")
    lib, _ = _library()
    stream = torch.cuda.current_stream(fdl.device).cuda_stream
    code = lib.airwave_mac_kmajor(
        fdl.data_ptr(), h.data_ptr(), out.data_ptr(), K, R, B, O,
        int(accumulate), int(generic), fdl.device.index or 0, stream,
    )
    _check_launch(lib, code, "mac_kmajor", O)
    return out


def pages_columns(O: int) -> int:
    """The columns per pass over the pages mac_kmajor_pages takes for O by
    default: 64, 48 or 32, the first that divides O, else 16."""
    return next((c for c in (64, 48, 32) if O % c == 0), 16)


def _check_pages(pages, bank, out):
    n = len(pages)
    if n == 0:
        raise ValueError("mac_kmajor_pages needs at least one page")
    if n > MAX_PAGES:
        raise ValueError(f"{n} pages exceed the kernel's {MAX_PAGES}")
    if pages[0].dim() != 3 or bank.dim() != 4:
        raise ValueError(f"pages [K,R,B] and bank [n,K,O,R] expected, got "
                         f"{tuple(pages[0].shape)} and {tuple(bank.shape)}")
    K, R, B = pages[0].shape
    O = bank.shape[2]
    for page in pages:
        if page.shape != (K, R, B):
            raise ValueError(f"page {tuple(page.shape)} differs from "
                             f"{tuple(pages[0].shape)}")
    if bank.shape != (n, K, O, R):
        raise ValueError(f"bank {tuple(bank.shape)} does not match {n} pages "
                         f"of {tuple(pages[0].shape)}: expected "
                         f"[{n}, {K}, O, {R}]")
    tensors = [bank, *pages]
    if out is not None:
        if out.shape != (O, K, B):
            raise ValueError(f"out {tuple(out.shape)}: expected [{O}, {K}, {B}]")
        tensors.append(out)
    _check_dtype_device(tensors)
    return K, R, B, O


def mac_kmajor_pages(pages, bank: torch.Tensor,
                     out: "torch.Tensor | None" = None, *,
                     columns: "int | None" = None) -> torch.Tensor:
    """pages n x [K, R, B], bank [n, K, O, R] -> [O, K, B], all float32:
    every page's contraction summed in page order, in one kernel launch on
    the card, at any B and any page offset (contiguous views included). The
    pages stay separate tensors (no stacking copy).

    `columns` (one of PAGES_COLUMNS) forces the kernel instance that takes
    that many output columns per pass over the pages; None takes
    pages_columns(O): one pass at the steady O = 32 and the dual-bank
    O = 64, two of 48 at the three-half O = 96. 16 is the A/B baseline;
    every route gives the same bits."""
    if columns is not None and columns not in PAGES_COLUMNS:
        raise ValueError(f"columns must be None or one of {PAGES_COLUMNS}, "
                         f"got {columns}")
    K, R, B, O = _check_pages(pages, bank, out)
    dev = bank.device
    if dev.type == "cpu":
        y = mac_kmajor_pages_ref(pages, bank)
        return y.contiguous() if out is None else out.copy_(y)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if out is None:
        out = torch.empty((O, K, B), dtype=torch.float32, device=dev)
    _check_contiguous(bank=bank, out=out,
                      **{f"page {a}": p for a, p in enumerate(pages)})
    if not (K > 0 and B > 0 and R > 0 and O > 0):
        raise ValueError(f"unsupported shape K={K} R={R} B={B} O={O}")
    lib, _ = _library()
    ptrs = (ctypes.c_void_p * len(pages))(*(p.data_ptr() for p in pages))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.airwave_mac_kmajor_pages(
        ptrs, len(pages), bank.data_ptr(), out.data_ptr(), K, R, B, O,
        columns or pages_columns(O), dev.index or 0, stream,
    )
    _check_launch(lib, code, "mac_kmajor_pages", O)
    return out
