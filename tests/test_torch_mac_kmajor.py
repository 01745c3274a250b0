"""kernels/mac_kmajor of the PyTorch port: the plain versions of mac_kmajor
and mac_kmajor_pages against the JAX Pallas kernel (interpret mode) and the
JAX paged MAC, the wrappers' checks and the build's failure without nvcc.
The CUDA kernels themselves are tested in test_torch_cuda.py."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.kernels.mac_kmajor import mac_kmajor as jax_mac_kmajor
from airwave_tpu.ops import upols as jupols
from airwave_tpu_torch.kernels import _build
from airwave_tpu_torch.kernels import mac_kmajor as mk
from airwave_tpu_torch.ops import upols as tupols


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


def test_ref_matches_jax_pallas_interpret():
    rng = np.random.default_rng(11)
    K, B, R, O = 72, 16, 36, 4
    x = rng.standard_normal((K, R, B)).astype(np.float32)
    h = rng.standard_normal((K, O, R)).astype(np.float32)
    ref = np.asarray(jax_mac_kmajor(jnp.asarray(x), jnp.asarray(h),
                                    interpret=True))
    got = mk.mac_kmajor(torch.from_numpy(x), torch.from_numpy(h))
    assert got.shape == (O, K, B) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(mk.mac_kmajor_ref(torch.from_numpy(x),
                                                 torch.from_numpy(h)).numpy(),
                               ref, rtol=0, atol=1e-4)


def _jax_paged_steps(hrir, T, B, M, steps, rng):
    """The JAX paged step run `steps` times from a zero carry: its pages and
    the last step's _paged_mac output permuted to [M, E, Q, Kp, B]."""
    S = hrir.shape[0]
    pj = jupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M)
    sj = jupols.make_conv_state_paged(B, S, pj.partition_count, T, M)
    for _ in range(steps):
        x = (rng.standard_normal((B, S, M, T)) * 0.5).astype(np.float32)
        sj, ykm = jupols.conv_step_paged_raw(pj, sj, jnp.asarray(x))
    Kp = tupols.padded_bin_count(T)
    pages = tuple(torch.tensor(np.asarray(pg)) for pg in sj.pages)
    ref = np.asarray(ykm).reshape(Kp, B, M, 2, 2).transpose(2, 3, 4, 0, 1)
    return pj.partition_count // M, pages, ref


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("n_pages", [1, 3, 5])
def test_paged_mac_matches_jax_paged_mac(n_pages, S):
    """mac_kmajor_pages_ref, the wrapper on CPU tensors and tupols._paged_mac
    against the JAX step's _paged_mac output, T=64, M=8 (R = S*C*M,
    O = M*E*Q = 32). HRIR lengths of 600 and 1800 taps give
    partition_count // M = 3 and 5. A step always has at least two pages (a
    bank's partitions plus M-1 zero ones), so one page is the first step
    from a zero carry: only the newest page is non-zero there, and the JAX
    output is its term alone."""
    rng = np.random.default_rng(10 * n_pages + S)
    T, B, M = 64, 16, 8
    taps = 1800 if n_pages == 5 else 600
    hrir = (rng.standard_normal((S, 2, taps)) * 0.3).astype(np.float32)
    steps = 1 if n_pages == 1 else n_pages + 1
    count, pages, ref = _jax_paged_steps(hrir, T, B, M, steps, rng)
    assert count == (3 if n_pages == 1 else n_pages)
    Kp = tupols.padded_bin_count(T)
    pt = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    bank = tupols.paged_bank(pt, M, Kp)
    assert bank.shape == (count, Kp, 32, S * 2 * M)
    if n_pages == 1:
        assert all(not pg.any() for pg in pages[1:])
        pages, bank = pages[:1], bank[:1]
    fdl = [pg.view(Kp, S * 2 * M, B) for pg in pages]
    plain = mk.mac_kmajor_pages_ref(fdl, bank)                # [O, Kp, B]
    assert rel_rms(plain.view(M, 2, 2, Kp, B).numpy(), ref) <= 1e-6
    mk.reset_launch_count()
    wrapped = mk.mac_kmajor_pages(fdl, bank)
    assert mk.launch_count("mac_kmajor_pages") == 0
    assert wrapped.is_contiguous() and torch.equal(wrapped, plain)
    got = tupols._paged_mac(pages, bank, M)                  # [M, E, Q, Kp, B]
    assert got.shape == (M, 2, 2, Kp, B)
    assert rel_rms(got.numpy(), ref) <= 1e-6


def test_accumulated_pages_match_jax_paged_mac():
    """Three pages at R = S*C*M = 32, O = M*E*Q = 32 (M = 8), summed by one
    mac_kmajor launch per page into one [O, Kp, B] buffer (accumulate=True,
    what mac_kmajor_pages replaces), against the JAX step's _paged_mac output
    (layout [Kp, B, 1, M, E, Q]) after a permute."""
    rng = np.random.default_rng(4)
    T, B, S, M = 64, 16, 2, 8
    hrir = (rng.standard_normal((S, 2, 600)) * 0.3).astype(np.float32)
    pj = jupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M)
    assert pj.partition_count // M == 3
    sj = jupols.make_conv_state_paged(B, S, pj.partition_count, T, M)
    for _ in range(3):
        x = (rng.standard_normal((B, S, M, T)) * 0.5).astype(np.float32)
        sj, ykm = jupols.conv_step_paged_raw(pj, sj, jnp.asarray(x))
    Kp = tupols.padded_bin_count(T)
    pt = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    bank = tupols.paged_bank(pt, M, Kp)
    assert bank.shape == (3, Kp, 32, 32)
    pages = [torch.tensor(np.asarray(pg)).view(Kp, 32, B) for pg in sj.pages]
    acc = mk.mac_kmajor(pages[0], bank[0])
    for page, h in zip(pages[1:], bank[1:]):
        assert mk.mac_kmajor(page, h, out=acc, accumulate=True) is acc
    ref = np.asarray(ykm).reshape(Kp, B, M, 2, 2).transpose(2, 3, 4, 0, 1)
    assert rel_rms(acc.view(M, 2, 2, Kp, B).numpy(), ref) <= 1e-6


def test_out_and_accumulate_forms():
    rng = np.random.default_rng(2)
    fdl = [torch.from_numpy(rng.standard_normal((8, 6, 5), dtype=np.float32))
           for _ in range(2)]
    h = [torch.from_numpy(rng.standard_normal((8, 3, 6), dtype=np.float32))
         for _ in range(2)]
    out = torch.full((3, 8, 5), 7.0)
    assert mk.mac_kmajor(fdl[0], h[0], out=out) is out
    torch.testing.assert_close(out, mk.mac_kmajor_ref(fdl[0], h[0]))
    mk.mac_kmajor(fdl[1], h[1], out=out, accumulate=True)
    torch.testing.assert_close(
        out, mk.mac_kmajor_ref(fdl[0], h[0]) + mk.mac_kmajor_ref(fdl[1], h[1]))


@pytest.mark.parametrize("case", ["h_shape", "out_shape", "no_out", "dtype"])
def test_wrapper_rejects_bad_operands(case):
    fdl = torch.zeros((8, 6, 5))
    h = torch.zeros((8, 3, 6))
    kwargs = {}
    if case == "h_shape":
        h = torch.zeros((8, 3, 7))
    elif case == "out_shape":
        kwargs = {"out": torch.zeros((3, 8, 4))}
    elif case == "no_out":
        kwargs = {"accumulate": True}
    else:
        fdl = fdl.double()
    with pytest.raises(ValueError):
        mk.mac_kmajor(fdl, h, **kwargs)


@pytest.mark.parametrize("case", ["count", "page_shape", "bank_shape",
                                  "out_shape", "dtype", "empty", "too_many"])
def test_pages_wrapper_rejects_bad_operands(case):
    pages = [torch.zeros((8, 6, 5)) for _ in range(3)]
    bank = torch.zeros((3, 8, 4, 6))
    kwargs = {}
    if case == "count":
        bank = torch.zeros((2, 8, 4, 6))
    elif case == "page_shape":
        pages[1] = torch.zeros((8, 6, 4))
    elif case == "bank_shape":
        bank = torch.zeros((3, 8, 4, 7))
    elif case == "out_shape":
        kwargs = {"out": torch.zeros((4, 8, 4))}
    elif case == "dtype":
        pages[2] = pages[2].double()
    elif case == "empty":
        pages, bank = [], torch.zeros((0, 8, 4, 6))
    else:
        n = mk.MAX_PAGES + 1
        pages, bank = pages[:1] * n, torch.zeros((n, 8, 4, 6))
    with pytest.raises(ValueError):
        mk.mac_kmajor_pages(pages, bank, **kwargs)


@pytest.mark.parametrize("columns", [8, 24, 40, 128])
def test_pages_wrapper_rejects_unknown_columns(columns):
    pages = [torch.zeros((8, 6, 5)) for _ in range(2)]
    with pytest.raises(ValueError, match="columns"):
        mk.mac_kmajor_pages(pages, torch.zeros((2, 8, 4, 6)), columns=columns)


@pytest.mark.parametrize("O,columns", [(4, 16), (8, 16), (16, 16), (24, 16),
                                       (32, 32), (48, 48), (64, 64),
                                       (96, 48), (128, 64), (40, 16)])
def test_pages_columns_per_pass(O, columns):
    """One pass over the pages at the steady O = 4M and the dual-bank 8M of
    M = 8, two of 48 at the three-half 96; any other O 16 at a time."""
    assert mk.pages_columns(O) == columns


@pytest.mark.parametrize("columns", mk.PAGES_COLUMNS)
def test_pages_every_route_runs_the_plain_version_on_cpu(columns):
    rng = np.random.default_rng(columns)
    pages = [torch.from_numpy(rng.standard_normal((8, 6, 5), dtype=np.float32))
             for _ in range(3)]
    bank = torch.from_numpy(rng.standard_normal((3, 8, 64, 6),
                                                dtype=np.float32))
    torch.testing.assert_close(
        mk.mac_kmajor_pages(pages, bank, columns=columns),
        mk.mac_kmajor_pages_ref(pages, bank), rtol=0, atol=0)


def test_pages_out_form():
    rng = np.random.default_rng(5)
    pages = [torch.from_numpy(rng.standard_normal((8, 6, 5), dtype=np.float32))
             for _ in range(2)]
    bank = torch.from_numpy(rng.standard_normal((2, 8, 3, 6), dtype=np.float32))
    out = torch.full((3, 8, 5), 7.0)
    assert mk.mac_kmajor_pages(pages, bank, out=out) is out
    torch.testing.assert_close(out, mk.mac_kmajor(pages[0], bank[0])
                               + mk.mac_kmajor(pages[1], bank[1]),
                               rtol=0, atol=0)


def test_cpu_launches_nothing():
    mk.reset_launch_count()
    mk.mac_kmajor(torch.zeros((8, 2, 3)), torch.zeros((8, 4, 2)))
    mk.mac_kmajor_pages([torch.zeros((8, 2, 3))] * 2, torch.zeros((2, 8, 4, 2)))
    assert mk.launch_count() == 0
    assert mk.launch_count("mac_kmajor_pages") == 0


def test_build_raises_without_nvcc(monkeypatch):
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        mk.build()


def _fade_bank(S, taps=300, T=64, Kp=72, seed=0):
    rng = np.random.default_rng(seed + S)
    hrir = (rng.standard_normal((S, 2, taps)) * 0.2).astype(np.float32)
    params = tupols.make_conv_params(hrir, T, device="cpu")
    return tupols.single_block_bank(params, Kp), params.partition_count


@pytest.mark.parametrize("S", [1, 2, 3])
def test_plain_version_reads_the_rotated_window(S):
    """The wrapper takes the single-block step's rotated window [Kp, O, S,
    P2, C] as it lies (a view of the doubled bank, not contiguous); on the
    CPU the plain version contracts it bit for bit as the contiguous copy
    _rotated_operand makes, at every cursor w."""
    bank, P2 = _fade_bank(S)
    Kp, O = bank.shape[:2]
    R = S * P2 * 2
    fdl = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (Kp, R, 5), dtype=np.float32))
    for w in range(P2):
        window = tupols._rotated_window(bank, w)
        assert window.shape == (Kp, O, S, P2, 2)
        assert window.data_ptr() == bank[:, :, :, P2 - 1 - w].data_ptr()
        assert not window.is_contiguous()
        assert mk.h_rows(window) == (bank.stride(0), bank.stride(1),
                                     bank.stride(2), P2 * 2)
        copy = tupols._rotated_operand(bank, w)
        assert torch.equal(mk.mac_kmajor_ref(fdl, window),
                           mk.mac_kmajor_ref(fdl, copy))
        assert torch.equal(mk.mac_kmajor(fdl, window),
                           mk.mac_kmajor(fdl, copy))


@pytest.mark.parametrize("case", ["r_strided", "c_strided", "p_strided",
                                  "four_axes", "r_mismatch"])
def test_wrapper_rejects_h_layouts_it_cannot_read(case):
    """A layout whose rows are not runs of contiguous floats raises
    ValueError before the device branch, with the message, on the CPU as
    on the card."""
    bank, P2 = _fade_bank(2)
    fdl = torch.zeros((72, 2 * P2 * 2, 3))
    h = {"r_strided": torch.zeros((72, 2 * P2 * 2, 4)).transpose(1, 2),
         "c_strided": tupols._rotated_window(bank, 0).transpose(3, 4),
         "p_strided": bank[:, :, :, ::2],
         "four_axes": torch.zeros((72, 4, 2, P2 * 2)),
         "r_mismatch": tupols._rotated_window(bank, 0)[:, :, :, 1:]}[case]
    if case == "p_strided":
        fdl = torch.zeros((72, 2 * P2 * 2, 3))
    match = {"four_axes": "window", "r_mismatch": "does not match"}.get(
        case, "runs of contiguous floats")
    with pytest.raises(ValueError, match=match):
        mk.mac_kmajor(fdl, h)


@pytest.mark.parametrize("B,O,want", [
    (1, 4, ("small", 2, 256)),         # live engine: 2 bins a CTA (260 CTAs)
    (1, 8, ("small", 2, 256)),         # its fade block
    (16, 4, ("small", 2, 256)),        # render graph: 2 bins, 128 outputs
    (16, 32, ("small", 1, 256)),       # 512 outputs: two a thread
    (16, 6, ("small", 2, 256)),        # any O
    (48, 4, ("small", 1, 256)),        # the widest small batch by default
    (49, 4, ("tiled", 256, 256)),      # B % 4 != 0: one tile
    (52, 4, ("tiled", 256, 256)),      # below BALANCED_MIN_BATCH
    (512, 4, ("balanced", 512, 128)),  # BALANCED_MIN_BATCH: one tile
    (516, 4, ("balanced", 640, 160)),  # serving soak's groups
    (1032, 4, ("balanced", 640, 160)),  # serve ring
    (1032, 8, ("balanced", 640, 160)),  # its fade
    (1032, 32, ("tiled", 256, 256)),   # the per-page baseline's O
    (2048, 4, ("balanced", 1024, 256)),  # grouped ring
    (2048, 12, ("tiled", 256, 256)),   # the three-half fade bank
    (16_384, 4, ("balanced", 1024, 256)),  # the bake at M = 1
    (150_129, 4, ("tiled", 256, 256)),  # ring capacity (B % 4 == 1)
    (150_129, 8, ("tiled", 256, 256)),
    (1032, 6, ("generic", 256, 256)),  # no tiled instance at O = 6
])
def test_mac_route_at_the_paths_widths(B, O, want):
    """mac_route, plain Python: small up to SMALL_MAX_BATCH lanes, with
    about two CTAs per SM (520 bins on 132 SMs: 2 a CTA) within
    SMALL_ITEMS outputs and 48 KB; above it balanced at O = 4 and 8 where
    B % 4 == 0 from BALANCED_MIN_BATCH lanes, tiled where O has an
    instance; generic where it has none."""
    route = mk.mac_route(520, 40, B, O)
    assert tuple(route) == want
    if route.name == "small":
        assert mk.small_smem_bytes(route.width, 40, B, O) <= 48 * 1024
        assert route.width == 1 or route.width * O * B <= mk.SMALL_ITEMS


def test_mac_route_forced_and_refused():
    assert mk.mac_route(520, 40, 256, 4, "small") == ("small", 1, 256)
    assert mk.mac_route(520, 40, 1, 4, "generic") == ("generic", 256, 256)
    assert mk.mac_route(520, 40, 1, 4, "tiled") == ("tiled", 256, 256)
    # Rows not 16-byte aligned: tiled, not four lanes a thread.
    assert mk.mac_route(520, 40, 1032, 4, aligned=False).name == "tiled"
    # Fewer SMs, more bins a CTA: 9 bins of 16 outputs fit beside the rows.
    assert mk.mac_route(520, 40, 1, 4, sms=32).width == 9
    with pytest.raises(ValueError, match="shared memory"):
        mk.mac_route(520, 200, 64, 4, "small")
    with pytest.raises(ValueError, match="tiled route"):
        mk.mac_route(520, 40, 1032, 6, "tiled")
    with pytest.raises(ValueError, match="balanced route"):
        mk.mac_route(520, 40, 1032, 6, "balanced")
    with pytest.raises(ValueError, match="balanced route"):
        mk.mac_route(520, 40, 1032, 32, "balanced")  # the fixed instance
    with pytest.raises(ValueError, match="route"):
        mk.mac_route(520, 40, 1032, 4, "fast")
    fdl, h = torch.zeros((8, 6, 5)), torch.zeros((8, 4, 6))
    with pytest.raises(ValueError, match="route"):
        mk._mac_kmajor(fdl, h, route="fast")
    # The public wrapper forces one route only, generic=True.
    with pytest.raises(TypeError):
        mk.mac_kmajor(fdl, h, route="small")


@pytest.mark.parametrize("B,O,want", [
    (1, 4, ("balanced", 32, 32)),        # B % 4 != 0: one lane a thread
    (16, 4, ("balanced", 128, 32)),      # four lanes a thread, one warp
    (516, 4, ("balanced", 640, 160)),    # one tile of 129 float4 lanes
    (1032, 4, ("balanced", 640, 160)),   # two of 129, not 5 of 256 (8 last)
    (1032, 12, ("balanced", 640, 160)),  # O = 12: forced only
    (2048, 12, ("balanced", 1024, 256)),
    (150_129, 4, ("balanced", 256, 256)),  # odd: 587 tiles of 256
])
def test_balanced_route_splits_b_evenly(B, O, want):
    """mac_route's balanced shape, plain Python: the fewest tiles of at
    most BALANCED_THREADS threads, V = 4 lanes a thread where B % 4 == 0
    (and the rows are 16-byte aligned), each tile rounded up to whole
    warps, so no tile pads more than one warp of lanes."""
    route = mk.mac_route(520, 40, B, O, "balanced")
    assert tuple(route) == want
    v = route.width // route.threads
    assert v in (1, 4) and route.threads % 32 == 0
    assert route.threads <= mk.BALANCED_THREADS
    tiles = -(-B // route.width)
    assert tiles * route.width - B < 32 * v * tiles
    unaligned = mk.mac_route(520, 40, B, O, "balanced", aligned=False)
    assert unaligned.width == unaligned.threads  # one lane a thread


@pytest.mark.parametrize("route", mk.ROUTES)
def test_every_route_runs_the_plain_version_on_cpu(route):
    rng = np.random.default_rng(len(route))
    fdl = torch.from_numpy(rng.standard_normal((8, 6, 5), dtype=np.float32))
    h = torch.from_numpy(rng.standard_normal((8, 4, 6), dtype=np.float32))
    mk.reset_launch_count()
    assert torch.equal(mk._mac_kmajor(fdl, h, route=route),
                       mk.mac_kmajor_ref(fdl, h))
    assert mk.launch_count() == 0 and mk.launch_routes() == {}
