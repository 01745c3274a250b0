"""The UPOLS delay-line MAC: hand-written CUDA kernels and their plain versions.

    Y[o, k, b] = sum_r fdl[k, r, b] * h[k, o, r]      fdl [K, R, B], h [K, O, R]

Port of the Pallas TPU kernel airwave_tpu/kernels/mac_kmajor.py:mac_kmajor.
`mac_kmajor` is the single-block contraction; `mac_kmajor_pages` sums it
over the n pages of the paged delay line in one launch,

    Y[o, k, b] = sum_a sum_r page_a[k, r, b] * bank[a, k, o, r],

the paged step's _paged_mac. Both kernels (csrc/mac_kmajor.cu, one build)
accumulate in exact fp32 FMAs, every output one chain in r order, so each
route of each kernel gives the same bits (the .cu file says how).

`mac_kmajor` reads h through its strides: a [K, O, R] tensor whose rows are
contiguous, or the single-block step's rotated window of the doubled bank
as it lies, a [K, O, S, P, C] view (upols.conv_step passes it, so no
per-step copy is made). `mac_route` picks its route by B and O: "small"
(several bins a CTA, up to SMALL_MAX_BATCH lanes), "balanced" (tiles that
split B evenly, four lanes a thread, where rows are 16-byte aligned, O is
in BALANCED_COLUMNS and B at least BALANCED_MIN_BATCH), "tiled" (256
lanes a CTA, one a thread, O in TILED_COLUMNS) or "generic" (the first
design: any O, and generic=True, the A/B baseline). `_mac_kmajor` forces
a route (chip_smoke.py and the tests time and check each one).

Dispatch is by the tensor's device alone: on a CUDA tensor a wrapper
launches its kernel or raises; on a CPU tensor it runs the plain PyTorch
version (`mac_kmajor_ref`, `mac_kmajor_pages_ref`) the tests hold the
kernel against.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import NamedTuple

import torch

from airwave_tpu_torch.kernels import _build
from airwave_tpu_torch.utils.profiling import BUILD_MAC_PLAN, span

SOURCE = "mac_kmajor.cu"
_MAX_SMEM_BYTES = 48 * 1024  # h[k] staged per CTA without opt-in smem
_MAX_GRID_Y = 65535          # one grid row per bin
MAX_PAGES = 32               # page pointers mac_kmajor_pages passes by value
PAGES_COLUMNS = (16, 32, 48, 64)  # mac_kmajor_pages' columns per pass

ROUTES = ("small", "tiled", "balanced", "generic")  # kernel ids 1, 2, 2, 0
_ROUTE_IDS = {"generic": 0, "small": 1, "tiled": 2, "balanced": 2}
SMALL_MAX_BATCH = 48     # the widest B the small route takes by default
SMALL_ITEMS = 256        # outputs of a small-route CTA, one a thread
TILED_COLUMNS = (4, 8, 12, 32)  # the O the tiled route has instances for
TILED_CONTIGUOUS = 32    # ... its instance on a contiguous h (the fixed one)
# Where the balanced route is the default: at O = 4 and 8 it ran faster
# than the tiled route on the H100 at every B from 516 lanes up, slower at
# O = 12, and slower at 64-128 lanes (route_crossover); no width between
# 128 and 516 was measured, so those keep the tiled route (PERF.md
# section 6).
BALANCED_COLUMNS = (4, 8)
BALANCED_MIN_BATCH = 512
BALANCED_THREADS = 256   # the most threads of a balanced-route CTA
THREADS = 256            # threads of a CTA, every other route
H100_SMS = 132

# Each launch's span (utils/profiling.span): by route or by columns per
# pass, and the plain versions' on CPU tensors.
SINGLE_SPANS = {r: "airwave.mac.single." + r for r in ROUTES}
PAGES_SPANS = {c: f"airwave.mac.pages.columns{c}" for c in PAGES_COLUMNS}
SINGLE_REF_SPAN = "airwave.mac.single.ref"
PAGES_REF_SPAN = "airwave.mac.pages.ref"

_launches = {"mac_kmajor": 0, "mac_kmajor_pages": 0}
_launches_by_columns: Counter = Counter()  # (kernel, O) -> launches
_launches_by_route: Counter = Counter()    # (kernel, route) -> launches


def launch_count(kernel: str = "mac_kmajor",
                 columns: "int | None" = None) -> int:
    """Launches of `kernel` since the last reset_launch_count(); with
    `columns`, only its launches at that output width O (a hot-swap round
    doubles the steady O)."""
    if columns is None:
        return _launches[kernel]
    return _launches_by_columns[kernel, columns]


def launch_routes(kernel: str = "mac_kmajor") -> dict:
    """{route: launches} of `kernel` since the last reset_launch_count(),
    each route taken (mac_kmajor: one of ROUTES; mac_kmajor_pages:
    "columns16" .. "columns64", its columns per pass)."""
    return {r: n for (k, r), n in sorted(_launches_by_route.items())
            if k == kernel and n}


def reset_launch_count() -> None:
    """Set every kernel's launch counts to 0."""
    for name in _launches:
        _launches[name] = 0
    _launches_by_columns.clear()
    _launches_by_route.clear()


def _flat_h(h: torch.Tensor) -> torch.Tensor:
    """h as [K, O, R]; a [K, O, S, P, C] window is reshaped (a copy where
    S > 1)."""
    return h if h.dim() == 3 else h.reshape(h.shape[0], h.shape[1], -1)


def mac_kmajor_ref(fdl: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [K, R, B] x [K, O, R] -> [O, K, B]. h may be
    a rotated window [K, O, S, P, C]; it is contracted as its contiguous
    [K, O, R] copy, the operand the step built before it passed the view."""
    return torch.einsum("krb,kor->okb", fdl, _flat_h(h).contiguous())


def mac_kmajor_pages_ref(pages, bank: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the paged MAC: the page-ordered sum of
    mac_kmajor_ref terms, pages n x [K, R, B], bank [n, K, O, R] -> [O, K, B]."""
    acc = mac_kmajor_ref(pages[0], bank[0])
    for page, h in zip(pages[1:], bank[1:]):
        acc = acc + mac_kmajor_ref(page, h)
    return acc


# airwave_mac_kmajor_strided(fdl, h, out, launch, accumulate, stream):
# `launch` a _Plan's 12 integers.
STRIDED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library():
    lib, log = _build.load(SOURCE)
    fn = lib.airwave_mac_kmajor_strided
    fn.argtypes = STRIDED_ARGTYPES
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


class MacRoute(NamedTuple):
    """A mac_kmajor launch's route (one of ROUTES) and shape: `width` bins
    a CTA (small) or lanes a CTA (tiled, generic: THREADS; balanced: 1 or 4
    a thread); `threads` a CTA."""
    name: str
    width: int
    threads: int


def _ceil_div(n: int, d: int) -> int:
    return -(-n // d)


def small_smem_bytes(bins: int, R: int, B: int, O: int) -> int:
    """Shared memory of a small-route CTA of `bins` bins: each bin's [R, B]
    slab padded to B (mod 32) floats and its O rows of h padded to an odd
    length (csrc/mac_kmajor.cu: small_xstride, small_hrow)."""
    slab = R * B
    return 4 * bins * (slab + (B - slab) % 32 + O * (R | 1))


@functools.lru_cache(maxsize=4096)
def mac_route(K: int, R: int, B: int, O: int, route: "str | None" = None,
              sms: int = H100_SMS, aligned: bool = True) -> MacRoute:
    """The route and shape of mac_kmajor at fdl [K, R, B], h [K, O, R] on a
    card of `sms` SMs. By default: small up to SMALL_MAX_BATCH lanes (CTAs
    of THREADS, as many bins each as give two CTAs per SM, within
    SMALL_ITEMS outputs and 48 KB of shared memory); else balanced where O
    is in BALANCED_COLUMNS, B >= BALANCED_MIN_BATCH, B % 4 == 0 and fdl
    and out are 16-byte `aligned` (four lanes a thread); else tiled where
    O is in TILED_COLUMNS; else generic. `route` forces one of ROUTES;
    ValueError where it cannot run. balanced (O in TILED_COLUMNS but
    TILED_CONTIGUOUS): ceil(B / V) thread lanes (V = 4 where B % 4 == 0
    and fdl and out are 16-byte `aligned`, else 1) split into the fewest
    tiles of at most BALANCED_THREADS, each rounded up to whole warps."""
    if route is None:
        route = ("small" if B <= SMALL_MAX_BATCH
                 and small_smem_bytes(1, R, B, O) <= _MAX_SMEM_BYTES
                 else "balanced" if O in BALANCED_COLUMNS and B % 4 == 0
                 and B >= BALANCED_MIN_BATCH and aligned
                 else "tiled" if O in TILED_COLUMNS else "generic")
    if route == "small":
        bins = max(1, min(_ceil_div(K, 2 * sms), SMALL_ITEMS // (O * B)))
        while bins > 1 and small_smem_bytes(bins, R, B, O) > _MAX_SMEM_BYTES:
            bins -= 1
        if small_smem_bytes(bins, R, B, O) > _MAX_SMEM_BYTES:
            raise ValueError(f"the small route's bin of R={R} B={B} O={O} "
                             f"exceeds {_MAX_SMEM_BYTES} B of shared memory")
        return MacRoute("small", bins, THREADS)
    if route == "tiled":
        if O not in TILED_COLUMNS:
            raise ValueError(f"the tiled route takes O in {TILED_COLUMNS}, "
                             f"got {O}")
        return MacRoute("tiled", THREADS, THREADS)
    if route == "balanced":
        if O not in TILED_COLUMNS or O == TILED_CONTIGUOUS:
            raise ValueError(f"the balanced route takes O in "
                             f"{TILED_COLUMNS} but {TILED_CONTIGUOUS}, "
                             f"got {O}")
        v = 4 if B % 4 == 0 and aligned else 1
        lanes = _ceil_div(B, v)
        per_tile = _ceil_div(lanes, _ceil_div(lanes, BALANCED_THREADS))
        threads = 32 * _ceil_div(per_tile, 32)
        return MacRoute("balanced", v * threads, threads)
    if route == "generic":
        return MacRoute("generic", THREADS, THREADS)
    raise ValueError(f"route must be None or one of {ROUTES}, got {route!r}")


def h_rows(h: torch.Tensor) -> tuple:
    """(k_stride, o_stride, s_stride, seg): where mac_kmajor finds row
    h[k, o], at k * k_stride + o * o_stride, its R floats in runs of seg
    contiguous floats, run s at s * s_stride. ValueError for a layout the
    kernel cannot read."""
    return _rows(h.shape, h.stride())


@functools.lru_cache(maxsize=256)
def _rows(shape: tuple, stride: tuple) -> tuple:
    if len(shape) == 3:
        if shape[2] == 1 or stride[2] == 1:
            return stride[0], stride[1], shape[2], shape[2]
    elif len(shape) == 5:
        P, C = shape[3:]
        if (C == 1 or stride[4] == 1) and (P == 1 or stride[3] == C):
            return stride[0], stride[1], stride[2], P * C
    raise ValueError(
        f"h {tuple(shape)} with strides {stride}: mac_kmajor reads h[k, o] "
        f"as runs of contiguous floats, from a [K, O, R] tensor with unit "
        f"stride along R or a [K, O, S, P, C] window whose (P, C) block is "
        f"contiguous")


@functools.lru_cache(maxsize=1024)
def _shapes(fshape: tuple, hshape: tuple, hstride: tuple) -> tuple:
    """(K, R, B, O, rows) of fdl and h by their shapes and h's strides;
    ValueError for shapes that do not match or a layout the kernel cannot
    read."""
    if len(fshape) != 3 or len(hshape) not in (3, 5):
        raise ValueError(f"fdl [K,R,B] and h [K,O,R] (or a [K,O,S,P,C] "
                         f"window) expected, got {tuple(fshape)} and "
                         f"{tuple(hshape)}")
    K, R, B = fshape
    O = hshape[1]
    if hshape[0] != K or math.prod(hshape[2:]) != R:
        raise ValueError(f"h {tuple(hshape)} does not match fdl "
                         f"{tuple(fshape)}: expected [{K}, O, {R}] or "
                         f"[{K}, O, S, P, C] with S*P*C = {R}")
    return K, R, B, O, _rows(hshape, hstride)


def _check(fdl, h, out, accumulate):
    K, R, B, O, rows = _shapes(fdl.shape, h.shape, h.stride())
    tensors = [fdl, h]
    if out is not None:
        if out.shape != (O, K, B):
            raise ValueError(f"out {tuple(out.shape)}: expected [{O}, {K}, {B}]")
        tensors.append(out)
    elif accumulate:
        raise ValueError("accumulate=True needs out")
    _check_dtype_device(tensors)
    return K, R, B, O, rows


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


def _check_launch(lib, code, name, O, route):
    if code != 0:
        msg = lib.airwave_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cuda error {code})")
    _launches[name] += 1
    _launches_by_columns[name, O] += 1
    _launches_by_route[name, route] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mac_kmajor(fdl: torch.Tensor, h: torch.Tensor,
               out: "torch.Tensor | None" = None,
               accumulate: bool = False, *, generic: bool = False
               ) -> torch.Tensor:
    """fdl [K, R, B], h [K, O, R] -> [O, K, B], all float32. h may also be
    the single-block step's rotated window [K, O, S, P, C] (R = S*P*C), a
    view the kernel reads where it lies (the generic kernel and the tiled
    route at O = TILED_CONTIGUOUS copy it first); h_rows says which
    layouts it takes.

    With `out` the result is written there; with accumulate=True it is
    added to what `out` holds (one launch per page summing pages this way
    is what mac_kmajor_pages replaces, and its baseline on the card).
    mac_route picks the kernel; generic=True runs the first design instead
    (the generic kernel, the A/B baseline). Every route gives the same bits."""
    return _mac_kmajor(fdl, h, out, accumulate, "generic" if generic else None)


class _Plan(NamedTuple):
    """A launch's route, whether h is copied contiguous first, the
    entry point's `launch` integers (K, R, B, O, h_k, h_o, h_s, seg, route
    id, width, threads, device) in an array held here, at `address`, and
    the launch's span name."""
    route: MacRoute
    copy: bool
    launch: ctypes.Array
    address: int
    span: str


@functools.lru_cache(maxsize=1024)
def _plan(K: int, R: int, B: int, O: int, rows: tuple, route, index: int,
          aligned: bool, contiguous: bool) -> _Plan:
    """The launch of mac_kmajor at these shapes on card `index` (fdl and
    out 16-byte `aligned` or not, h `contiguous` [K, O, R] or not): `route`
    resolved to a MacRoute (None: mac_route's choice; a name of ROUTES; or
    a MacRoute as is), and h copied contiguous where its kernel reads h[k]
    as one run (the generic kernel; the tiled route at O =
    TILED_CONTIGUOUS). Cached, so a call of the wrapper does no more of
    this than a lookup. ValueError for a shape the kernels cannot take."""
    with span(BUILD_MAC_PLAN):
        if O * R * 4 > _MAX_SMEM_BYTES:
            raise ValueError(f"h[k] of {O}x{R} floats exceeds the kernel's "
                             f"{_MAX_SMEM_BYTES} B of shared memory")
        if not (0 < K <= _MAX_GRID_Y and B > 0 and R > 0 and O > 0):
            raise ValueError(f"unsupported shape K={K} R={R} B={B} O={O}")
        if not isinstance(route, MacRoute):
            route = mac_route(K, R, B, O, route, _sm_count(index), aligned)
        copy = not contiguous and (route.name == "generic"
                                   or O == TILED_CONTIGUOUS)
        if copy:
            rows = (O * R, R, R, R)  # h_rows of the [K, O, R] copy
        launch = (ctypes.c_longlong * 12)(
            K, R, B, O, *rows, _ROUTE_IDS[route.name], route.width,
            route.threads, index)
        return _Plan(route, copy, launch, ctypes.addressof(launch),
                     SINGLE_SPANS[route.name])


def _mac_kmajor(fdl, h, out=None, accumulate=False,
                route: "str | MacRoute | None" = None) -> torch.Tensor:
    """mac_kmajor on `route`: None (mac_route's choice), one of ROUTES, or
    a MacRoute shape (chip_smoke.py times shapes of a route in turns)."""
    K, R, B, O, rows = _check(fdl, h, out, accumulate)
    name = route.name if isinstance(route, MacRoute) else route
    if not (name is None or name in ROUTES):
        raise ValueError(f"route must be None or one of {ROUTES}, got "
                         f"{route!r}")
    if fdl.device.type == "cpu":
        with span(SINGLE_REF_SPAN):
            y = mac_kmajor_ref(fdl, h)
            if out is None:
                return y.contiguous()  # the kernel's layout, callers view it
            return out.add_(y) if accumulate else out.copy_(y)
    if fdl.device.type != "cuda":
        raise ValueError(f"unsupported device {fdl.device}")
    if out is None:
        out = torch.empty((O, K, B), dtype=torch.float32, device=fdl.device)
    _check_contiguous(fdl=fdl, out=out)
    fdl_ptr, out_ptr = fdl.data_ptr(), out.data_ptr()
    plan = _plan(K, R, B, O, rows, route, fdl.device.index or 0,
                 (fdl_ptr | out_ptr) % 16 == 0,
                 h.dim() == 3 and h.is_contiguous())
    with span(plan.span):
        if plan.copy:
            h = _flat_h(h).contiguous()  # these kernels read h[k] as one run
        lib, _ = _library()
        code = lib.airwave_mac_kmajor_strided(
            fdl_ptr, h.data_ptr(), out_ptr, plan.address, int(accumulate),
            torch.cuda.current_stream(fdl.device).cuda_stream)
        _check_launch(lib, code, "mac_kmajor", O, plan.route.name)
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
        with span(PAGES_REF_SPAN):
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
    columns = columns or pages_columns(O)
    with span(PAGES_SPANS[columns]):
        lib, _ = _library()
        ptrs = (ctypes.c_void_p * len(pages))(*(p.data_ptr() for p in pages))
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.airwave_mac_kmajor_pages(
            ptrs, len(pages), bank.data_ptr(), out.data_ptr(), K, R, B, O,
            columns, dev.index or 0, stream,
        )
        _check_launch(lib, code, "mac_kmajor_pages", O, f"columns{columns}")
    return out
