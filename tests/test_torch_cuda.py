"""Tests of the PyTorch port that need a CUDA card (marker `cuda`; they skip
without one). This file imports no jax, so it runs on a machine with a card
and no jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from airwave_tpu_torch.assets import channel_maps
from airwave_tpu_torch.graph.renderer import prepare_renderer
from airwave_tpu_torch.io.wav import WAVData
from airwave_tpu_torch.kernels import mac_kmajor as mk
from airwave_tpu_torch.models.bake import bake
from airwave_tpu_torch.models.binaural import BinauralEngine
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import upols
from airwave_tpu_torch.runtime.stream_pool import PoolProfile, StreamPool

pytestmark = pytest.mark.cuda


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("K,R,O,B", [(520, 40, 4, 16384), (520, 32, 32, 1000),
                                     (24, 7, 5, 300), (8, 3, 33, 129)])
def test_kernel_matches_plain(cuda_device, K, R, O, B):
    rng = np.random.default_rng(K + R + O + B)
    fdl = torch.tensor(rng.standard_normal((K, R, B), dtype=np.float32),
                       device=cuda_device)
    h = torch.tensor(rng.standard_normal((K, O, R), dtype=np.float32),
                     device=cuda_device)
    mk.reset_launch_count()
    got = mk.mac_kmajor(fdl, h)
    acc = mk.mac_kmajor(fdl, h, out=got.clone(), accumulate=True)
    torch.cuda.synchronize()
    assert mk.launch_count() == 2
    ref = mk.mac_kmajor_ref(fdl.double(), h.double()).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), ref) <= 1e-6
    assert rel_rms(acc.cpu().numpy(), 2 * ref) <= 1e-6


@pytest.mark.parametrize("K,R,B", [(520, 40, 8192), (24, 7, 300), (8, 13, 129)])
def test_dual_bank_instance_equals_generic(cuda_device, K, R, B):
    """The hot-swap round's O = 8 runs its own instance, bit for bit equal
    to the generic kernel it replaces in the dispatch, and within 1e-6 of
    float64."""
    rng = np.random.default_rng(K + R + B)
    fdl = torch.tensor(rng.standard_normal((K, R, B), dtype=np.float32),
                       device=cuda_device)
    h = torch.tensor(rng.standard_normal((K, 8, R), dtype=np.float32),
                     device=cuda_device)
    mk.reset_launch_count()
    got = mk.mac_kmajor(fdl, h)
    assert mk.launch_count("mac_kmajor", columns=8) == 1
    assert torch.equal(got, mk.mac_kmajor(fdl, h, generic=True))
    ref = mk.mac_kmajor_ref(fdl.double(), h.double()).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), ref) <= 1e-6
    plain = mk.mac_kmajor_ref(fdl, h).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), plain) <= 1e-6


@pytest.mark.parametrize("n,K,R,O,B", [
    (3, 520, 32, 64, 1000),   # the paged hot-swap round's dual bank (M = 8)
    (2, 24, 12, 96, 130),     # two passes of 48, rows not 16-byte aligned
    (4, 16, 7, 64, 5),        # ragged R and B
])
def test_pages_kernel_wide_columns_equal_narrow(cuda_device, n, K, R, O, B):
    """O = 64 takes all its columns in one pass over the pages and O = 96
    two of 48: bit for bit what 16 columns per pass (four or six passes)
    gives, within 1e-6 of float64, one launch."""
    rng = np.random.default_rng(n + K + R + O + B)
    pages = [torch.tensor(rng.standard_normal((K, R, B), dtype=np.float32),
                          device=cuda_device) for _ in range(n)]
    bank = torch.tensor(rng.standard_normal((n, K, O, R), dtype=np.float32),
                        device=cuda_device)
    mk.reset_launch_count()
    got = mk.mac_kmajor_pages(pages, bank)
    assert mk.launch_count("mac_kmajor_pages", columns=O) == 1
    assert torch.equal(got, mk.mac_kmajor_pages(pages, bank, columns=16))
    exact = mk.mac_kmajor_pages_ref([p.double() for p in pages],
                                    bank.double()).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), exact) <= 1e-6
    plain = mk.mac_kmajor_pages_ref(pages, bank).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), plain) <= 1e-6


ROUTE_WIDTHS = (1, 2, 3, 15, 16, 17, 31, 33, 48, 49, 255, 256, 257, 516, 1024,
                1032, 2048, 8193)


@pytest.mark.parametrize("O", [4, 8, 12, 32, 6])
@pytest.mark.parametrize("B", ROUTE_WIDTHS)
def test_every_route_equals_generic(cuda_device, B, O):
    """Each route mac_kmajor can take at this shape (small where its CTA
    fits shared memory, tiled where O has an instance, balanced where it
    has one on a strided h, and mac_route's
    default) equals the generic kernel bit for bit, with and without
    accumulate, and is within 1e-6 of float64, at R = 20, 36, 40 and
    K = 520, 24."""
    for K in (520, 24):
        for R in (20, 36, 40):
            rng = np.random.default_rng(B * 1000 + O * 100 + R + K)
            fdl = torch.tensor(rng.standard_normal((K, R, B), dtype=np.float32),
                               device=cuda_device)
            h = torch.tensor(rng.standard_normal((K, O, R), dtype=np.float32),
                             device=cuda_device)
            old = torch.tensor(rng.standard_normal((O, K, B), dtype=np.float32),
                               device=cuda_device)
            want = mk.mac_kmajor(fdl, h, generic=True)
            want_acc = mk.mac_kmajor(fdl, h, out=old.clone(), accumulate=True,
                                     generic=True)
            routes = [None, "small", "tiled", "balanced"]
            if O not in mk.TILED_COLUMNS:
                routes.remove("tiled")
            if O not in mk.TILED_COLUMNS or O == mk.TILED_CONTIGUOUS:
                routes.remove("balanced")
            if mk.small_smem_bytes(1, R, B, O) > 48 * 1024:
                routes.remove("small")
            for route in routes:
                mk.reset_launch_count()
                got = mk._mac_kmajor(fdl, h, route=route)
                acc = mk._mac_kmajor(fdl, h, out=old.clone(), accumulate=True,
                                     route=route)
                torch.cuda.synchronize()
                name = route or mk.mac_route(K, R, B, O).name
                assert mk.launch_routes() == {name: 2}, (K, R, route)
                assert torch.equal(got, want), (K, R, route)
                assert torch.equal(acc, want_acc), (K, R, route)
            ref = mk.mac_kmajor_ref(fdl.double(), h.double())
            assert rel_rms(want.cpu().numpy(), ref.cpu().numpy()) <= 1e-6
            assert rel_rms(want_acc.cpu().numpy(),
                           (ref + old.double()).cpu().numpy()) <= 1e-6


@pytest.mark.parametrize("S", [1, 2])
def test_rotated_window_in_place_equals_contiguous(cuda_device, S):
    """The single-block step's rotated window of the doubled bank, read in
    place (one launch, no copy of the operand), equals the kernel on
    _rotated_operand's contiguous copy bit for bit at every cursor w, on the
    small, the balanced and the tiled routes."""
    rng = np.random.default_rng(S)
    T = 512
    params = upols.make_conv_params(
        (rng.standard_normal((S, 2, 4320)) * 0.05).astype(np.float32), T,
        device=cuda_device)
    Kp = upols.padded_bin_count(T)
    bank = upols.single_block_bank(params, Kp)
    P2 = params.partition_count
    for B in (1, 16, 1032):
        fdl = torch.randn((Kp, S * P2 * 2, B), device=cuda_device)
        for w in range(P2):
            window = upols._rotated_window(bank, w)
            copy = upols._rotated_operand(bank, w)
            mk.reset_launch_count()
            got = mk.mac_kmajor(fdl, window)
            assert mk.launch_count() == 1
            assert mk.launch_routes() == {
                mk.mac_route(Kp, fdl.shape[1], B, 4).name: 1}
            assert torch.equal(got, mk.mac_kmajor(fdl, copy)), (B, w)
            assert torch.equal(got, mk.mac_kmajor(fdl, window, generic=True))
            for route in ("tiled", "balanced"):
                assert torch.equal(got, mk._mac_kmajor(fdl, window,
                                                       route=route))
        torch.cuda.synchronize()


def test_balanced_route_on_unaligned_rows(cuda_device):
    """fdl and out at a 4-byte offset (contiguous, B % 4 == 0): the balanced
    route takes one lane a thread and equals the generic kernel; a forced
    four-lane shape is refused by the kernel (a launch error, no launch
    counted, no fallback)."""
    K, R, B, O = 24, 40, 1032, 4
    rng = np.random.default_rng(7)
    flat = torch.tensor(rng.standard_normal(K * R * B + 1, dtype=np.float32),
                        device=cuda_device)
    fdl = flat[1:].view(K, R, B)
    h = torch.tensor(rng.standard_normal((K, O, R), dtype=np.float32),
                     device=cuda_device)
    out = torch.empty(O * K * B + 1, device=cuda_device)[1:].view(O, K, B)
    want = mk.mac_kmajor(fdl, h, generic=True)
    mk.reset_launch_count()
    got = mk._mac_kmajor(fdl, h, out=out, route="balanced")
    assert mk.launch_routes() == {"balanced": 1}
    assert torch.equal(got, want)
    four = mk.mac_route(K, R, B, O, "balanced")
    assert four.width == 4 * four.threads
    with pytest.raises(RuntimeError, match="launch failed"):
        mk._mac_kmajor(fdl, h, out=out, route=four)
    assert mk.launch_count() == 1


def test_kernel_rejects_non_contiguous(cuda_device):
    fdl = torch.zeros((8, 5, 6), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mac_kmajor(fdl, torch.zeros((8, 4, 6), device=cuda_device))
    # h whose rows are not runs of contiguous floats: refused, no launch.
    h = torch.zeros((8, 6, 4), device=cuda_device).transpose(1, 2)
    mk.reset_launch_count()
    with pytest.raises(ValueError, match="runs of contiguous floats"):
        mk.mac_kmajor(torch.zeros((8, 6, 5), device=cuda_device), h)
    assert mk.launch_count() == 0


@pytest.mark.parametrize("n,K,R,O,B", [
    (3, 520, 32, 32, 1000),   # the paged step's page, a ragged last tile
    (1, 24, 8, 16, 300),      # one page, O = 16 (M = 4)
    (13, 40, 128, 32, 129),   # a long bank: 13 pages, 16 KB of bank per bin
    (2, 8, 12, 33, 5),        # generic O, rows not 16-byte aligned
    (4, 16, 7, 20, 130),      # R % 4 != 0: the bank by 4-byte copies
])
def test_pages_kernel_matches_per_page_launches(cuda_device, n, K, R, O, B):
    """The fused kernel equals one mac_kmajor launch per page summed with
    accumulate=True, bit for bit (the same r-order FMAs and page-order
    adds), and float64 within 1e-6; one launch, written into `out` too."""
    rng = np.random.default_rng(n + K + R + O + B)
    pages = [torch.tensor(rng.standard_normal((K, R, B), dtype=np.float32),
                          device=cuda_device) for _ in range(n)]
    bank = torch.tensor(rng.standard_normal((n, K, O, R), dtype=np.float32),
                        device=cuda_device)
    mk.reset_launch_count()
    got = mk.mac_kmajor_pages(pages, bank)
    torch.cuda.synchronize()
    assert mk.launch_count("mac_kmajor_pages") == 1
    acc = mk.mac_kmajor(pages[0], bank[0])
    for page, h in zip(pages[1:], bank[1:]):
        mk.mac_kmajor(page, h, out=acc, accumulate=True)
    assert torch.equal(got, acc)
    out = torch.full((O, K, B), 7.0, device=cuda_device)
    assert mk.mac_kmajor_pages(pages, bank, out=out) is out
    assert torch.equal(out, got)
    exact = mk.mac_kmajor_pages_ref([p.double() for p in pages],
                                    bank.double()).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), exact) <= 1e-6


def _pages_at_offset(rng, n, K, R, B, offset, device):
    """n pages [K, R, B], each a contiguous view at `offset` floats into its
    own buffer (offset 1-3: the page base is not 16-byte aligned)."""
    return [torch.tensor(rng.standard_normal(offset + K * R * B,
                                             dtype=np.float32),
                         device=device)[offset:].view(K, R, B)
            for _ in range(n)]


@pytest.mark.parametrize("n,K,R,O,B,offset", [
    # Lane counts B % 4 = 1, 2, 3 (the capacity pools' widths) at the
    # steady, dual-bank and three-half O: rows 16-byte aligned in turns.
    *[(3, 24, 32, O, B, 0) for B in (1001, 1002, 1003) for O in (32, 64, 96)],
    (3, 24, 32, 64, 1024, 1),   # page bases 4 bytes past 16-byte alignment
    (3, 24, 32, 32, 1030, 2),   # 8 bytes past, and B % 4 = 2
    (1, 24, 32, 64, 515, 0),    # one page
    (13, 16, 24, 32, 259, 3),   # 13 pages, R % 16 != 0, 12 bytes past
    (3, 520, 32, 32, 1032, 0),  # the serve pool's width: a ragged last tile
    (3, 24, 32, 96, 1027, 0),   # a last tile of 3 lanes, split by columns
    (2, 8, 7, 48, 5, 1),        # rows of 5 lanes: some hold no whole 16 B
    # Banks that stay resident beside a shallower ring: 7 stages at O = 64
    # (one pass), 6 at O = 96 (two of 48); the three pages of a 5.1 and a
    # 7.1 input at M = 8 (R = 96: 2 stages at O = 32, 5 at O = 64; R = 128:
    # 2 stages at O = 32).
    (4, 24, 40, 64, 1001, 0),
    (4, 24, 40, 96, 1003, 2),
    (3, 24, 96, 32, 1001, 0),
    (3, 24, 96, 64, 1002, 1),
    (3, 24, 128, 32, 1003, 3),
    # Banks too large to stay resident beside 2 stages: streamed in the
    # stages, at O = 32, 64 and 96.
    (13, 8, 128, 32, 301, 1),
    (13, 8, 128, 64, 1003, 0),
    (8, 8, 128, 96, 257, 2),
])
def test_pages_kernel_at_any_width_and_offset(cuda_device, n, K, R, O, B,
                                              offset):
    """At lane counts that are no multiple of 4 and pages whose base is not
    16-byte aligned the fused kernel takes its rows by bulk copy all the
    same: bit for bit one mac_kmajor launch per page with accumulate=True
    and its own 16-column route, within 1e-6 of float64, one launch, and
    into an `out` that is itself an unaligned view."""
    rng = np.random.default_rng(n + K + R + O + B + offset)
    pages = _pages_at_offset(rng, n, K, R, B, offset, cuda_device)
    bank = torch.tensor(rng.standard_normal((n, K, O, R), dtype=np.float32),
                        device=cuda_device)
    mk.reset_launch_count()
    got = mk.mac_kmajor_pages(pages, bank)
    torch.cuda.synchronize()
    assert mk.launch_count("mac_kmajor_pages", columns=O) == 1
    acc = mk.mac_kmajor(pages[0], bank[0])
    for page, h in zip(pages[1:], bank[1:]):
        mk.mac_kmajor(page, h, out=acc, accumulate=True)
    assert torch.equal(got, acc)
    assert torch.equal(got, mk.mac_kmajor_pages(pages, bank, columns=16))
    out = torch.full((offset + O * K * B,), 7.0,
                     device=cuda_device)[offset:].view(O, K, B)
    assert mk.mac_kmajor_pages(pages, bank, out=out) is out
    assert torch.equal(out, got)
    exact = mk.mac_kmajor_pages_ref([p.double() for p in pages],
                                    bank.double()).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), exact) <= 1e-6


def test_pages_kernel_rejects_non_contiguous(cuda_device):
    pages = [torch.zeros((8, 6, 5), device=cuda_device) for _ in range(2)]
    pages[1] = torch.zeros((8, 5, 6), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mac_kmajor_pages(pages, torch.zeros((2, 8, 4, 6), device=cuda_device))


@pytest.mark.parametrize("M", [1, 4])
def test_bake_on_card_matches_cpu(cuda_device, M):
    """The whole bake on the card equals the CPU bake (plain versions) at a
    tiny size, batch not a multiple of the CTA width. Each step launches one
    kernel: mac_kmajor_pages at M > 1 (all pages fused), mac_kmajor at 1."""
    rng = np.random.default_rng(M)
    hrir = (rng.standard_normal((2, 2, 300)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((5, 2, 9 * 64 + 7)) * 0.4).astype(np.float32)
    preamp, coeffs = bd.design_cascade(None, 48_000.0)
    mk.reset_launch_count()
    y_gpu, state = bake(hrir, x, 48_000.0, coeffs, preamp, block_size=64,
                        blocks_per_step=M, device=cuda_device)
    steps = -(-x.shape[-1] // (64 * M))
    used, unused = (("mac_kmajor_pages", "mac_kmajor") if M > 1
                    else ("mac_kmajor", "mac_kmajor_pages"))
    assert mk.launch_count(used) == steps
    assert mk.launch_count(unused) == 0
    y_cpu, _ = bake(hrir, x, 48_000.0, coeffs, preamp, block_size=64,
                    blocks_per_step=M, device="cpu")
    assert rel_rms(y_gpu, y_cpu) <= 1e-6
    conv = state.conv.pages[0] if M > 1 else state.conv.fdl
    assert conv.device.type == "cuda"


def test_roll_then_step_on_card_matches_cpu(cuda_device):
    """A masked ring step, a lane roll and the next step on the card: the
    roll writes the delay line in place, so the kernel's operand stays one
    contiguous buffer, and the result equals the CPU ops."""
    rng = np.random.default_rng(2)
    B, S, T = 5, 2, 64
    hrir = (rng.standard_normal((S, 2, 300)) * 0.3).astype(np.float32)
    states, outs = [], []
    for dev in (cuda_device, torch.device("cpu")):
        params = upols.make_conv_params(hrir, T, device=dev)
        st = upols.make_conv_state(B, S, params.partition_count, T, dev)
        ys = []
        step_rng = np.random.default_rng(3)
        for i in range(6):
            active = np.ones(B, bool) if i in (0, 4, 5) else step_rng.random(B) < 0.5
            x = torch.tensor(step_rng.standard_normal((B, S, T), dtype=np.float32),
                             device=dev)
            if i == 4:
                lanes = torch.tensor([1, 3], device=dev)
                st = upols.conv_roll_lanes(st, lanes,
                                           torch.tensor([2, 1], device=dev))
            st, y = upols.conv_step(params, st, x,
                                    active_mask=torch.tensor(active, device=dev))
            assert st.fdl.is_contiguous()
            ys.append(y.cpu().numpy())
        states.append(st.fdl.cpu().numpy())
        outs.append(np.stack(ys))
    assert rel_rms(states[0], states[1]) <= 1e-6
    assert rel_rms(outs[0], outs[1]) <= 1e-6


def _preset(gain):
    kinds = (bd.FilterType.PEAKING, bd.FilterType.LOW_SHELF)
    return bd.EqualizerDefinition(-1.0, tuple(
        bd.EqualizerFilter(i + 1, i + 1, True, kinds[i], 300.0 * (i + 1),
                           gain * (-1.0) ** i, 0.9) for i in range(2)))


@pytest.mark.parametrize("M", [1, 2])
def test_pool_on_card_matches_cpu_pool(cuda_device, M):
    """The serving pool on the card (pinned staging, deferred delivery)
    against the same pool on the CPU, at 5 lanes (not a multiple of the
    kernels' 256-lane tile), with ragged traffic, a retarget and a detach
    and re-attach. Each round on the card launches one kernel:
    mac_kmajor_pages on the paged tier, mac_kmajor on the ring."""
    T, lanes = 64, 5
    rng = np.random.default_rng(M)
    wav = WAVData(48_000.0, (rng.standard_normal((14, 300)) * 0.2).astype(
        np.float32))
    pools = []
    for dev in (cuda_device, torch.device("cpu")):
        renderer = prepare_renderer(wav, channel_maps.STEREO, 48_000.0, T,
                                    lookahead=M, device=dev)
        pool = StreamPool(lanes, 48_000.0, renderer, eq_definition=_preset(2.0),
                          block_size=T, blocks_per_step=M, device=dev)
        for _ in range(lanes):
            pool.attach()
        pools.append(pool)
    step = pools[0].step_frames
    outs = [[[] for _ in range(lanes)] for _ in pools]
    mk.reset_launch_count()
    card_rounds = 0
    for rnd in range(40):
        if rnd == 12:
            for pool in pools:
                pool.set_equalizer(_preset(-3.0))
        if rnd == 20:
            for pool in pools:
                pool.detach(2)
        if rnd == 24:
            for pool in pools:
                assert pool.attach() == 2
        fed = rng.random(lanes) < 0.7
        if 20 <= rnd < 24:
            fed[2] = False
        fed = np.nonzero(fed)[0]
        chunks = (rng.standard_normal((len(fed), 2, step)) * 0.3).astype(
            np.float32)
        for pool, out in zip(pools, outs):
            pool.push_many(fed, chunks)
            rounds = pool.pump()
            assert rounds == (1 if len(fed) else 0)
            card_rounds += rounds if pool is pools[0] else 0
            y = pool.pull_many(fed, step)
            for j, lane in enumerate(fed):
                out[lane].append(y[j])
    used, unused = (("mac_kmajor_pages", "mac_kmajor") if M > 1
                    else ("mac_kmajor", "mac_kmajor_pages"))
    assert card_rounds > 0 and mk.launch_count(used) == card_rounds
    assert mk.launch_count(unused) == 0
    assert pools[0].stats()["debt_rolls"] > 0
    for a, b in zip(*outs):
        assert rel_rms(np.concatenate(a, -1), np.concatenate(b, -1)) <= 1e-5


def _wav(seed, frames=300):
    rng = np.random.default_rng(seed)
    return WAVData(48_000.0, (rng.standard_normal((14, frames)) * 0.2).astype(
        np.float32))


def test_engine_swap_on_card_matches_cpu(cuda_device):
    """BinauralEngine with a live EQ through two crossfaded swaps (the
    second mid-fade, restarting from the lerped bank) on the card against
    the same engine on the CPU; each fade block launches mac_kmajor at
    O = 8, each steady block at O = 4."""
    T, lanes = 64, 5
    x = (np.random.default_rng(3).standard_normal((lanes, 2, 12 * T)) * 0.3
         ).astype(np.float32)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        rs = [prepare_renderer(_wav(s), channel_maps.STEREO, 48_000.0, T,
                               device=dev) for s in (1, 2, 3)]
        eng = BinauralEngine(lanes, 48_000.0, T, renderer=rs[0], device=dev)
        eng.prepare_equalizer(_preset(2.0))
        mk.reset_launch_count()
        ys = []
        for b in range(12):
            if b == 4:
                assert eng.set_renderer(rs[1]) is True
            if b == 6:
                assert eng.set_renderer(rs[2]) is True
            ys.append(eng.process_block(x[:, :, b * T:(b + 1) * T]))
        outs.append(np.concatenate(ys, -1))
        if dev.type == "cuda":
            # The 20 ms fade is 15 blocks of 64: blocks 4 on are all fading.
            assert mk.launch_count("mac_kmajor", columns=8) == 8
            assert mk.launch_count("mac_kmajor", columns=4) == 4
    assert rel_rms(outs[0], outs[1]) <= 1e-5


@pytest.mark.parametrize("M", [1, 8])
def test_pool_fade_round_on_card_matches_cpu(cuda_device, M):
    """Hot-swap rounds on each tier, card against CPU, with one lane paused
    across the swap. The fade mask is not raced: as soon as the swap round
    is delivered (on_deliver) every lane is marked pending again, on both
    pools alike, and the card's audio still equals the CPU's (a mask read
    from the live array after that change would differ). Each fade round
    launches the MAC once at twice the steady columns (O = 8 ring, O = 64
    paged): the swap round, the round re-armed by that change, and the
    paused lane's rejoin."""
    T, lanes = 64, 6
    rng = np.random.default_rng(M)
    pools = []
    for dev in (cuda_device, torch.device("cpu")):
        rs = [prepare_renderer(_wav(s), channel_maps.STEREO, 48_000.0, T,
                               lookahead=M, device=dev) for s in (4, 5)]
        pool = StreamPool(lanes, 48_000.0, rs[0], eq_definition=_preset(1.0),
                          block_size=T, blocks_per_step=M, device=dev)
        for _ in range(lanes):
            pool.attach()
        pools.append((pool, rs[1]))
    step = pools[0][0].step_frames
    outs = [[[] for _ in range(lanes)] for _ in pools]
    chunks = (rng.standard_normal((8, lanes, 2, step)) * 0.3).astype(np.float32)
    steady, dual = (4, 8) if M == 1 else (32, 64)
    mk.reset_launch_count()
    for rnd in range(8):
        fed = np.arange(lanes - 1) if 2 <= rnd < 5 else np.arange(lanes)
        for (pool, new), out in zip(pools, outs):
            rearm = None
            if rnd == 3:
                assert pool.set_renderer(new) is True
                rearm = lambda p=pool: p._xfade_pending.fill(True)  # noqa: E731
            pool.push_many(fed, chunks[rnd, fed])
            assert pool.pump(on_deliver=rearm) == 1
            for j, y in zip(fed, pool.pull_many(fed, step)):
                out[j].append(y)
    name = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    assert mk.launch_count(name, columns=dual) == 3
    assert mk.launch_count(name, columns=steady) == 5
    assert pools[0][0].stats()["fade_rounds"] == 3
    for a, b in zip(*outs):
        assert rel_rms(np.concatenate(a, -1), np.concatenate(b, -1)) <= 1e-5


@pytest.mark.parametrize("M", [1, 8])
def test_grouped_pool_on_card_matches_cpu(cuda_device, M):
    """A grouped pool (3 groups, banks of 300, 700 and 300 frames, so
    group 1 carries its own partition count) on the card against the same
    pool on the CPU, through ragged rounds, a set_equalizer(group=1)
    retarget, swaps of groups 0 and 2 landing in one round and a second
    swap of group 0 while its paused lane still owes the first fade (the
    three-half fade bank). Every round on the card launches the tier's MAC
    once per group: mac_kmajor at O = 4, mac_kmajor_pages at O = 4M; in a
    fade round every group runs a fade bank (the groups not swapping their
    self-crossfade) at twice that, the three-half bank at three times."""
    T, G, lanes = 64, 3, 6
    rng = np.random.default_rng(10 + M)
    pools = []
    for dev in (cuda_device, torch.device("cpu")):
        rs = [prepare_renderer(_wav(s, f), channel_maps.STEREO, 48_000.0, T,
                               lookahead=M, device=dev)
              for s, f in ((6, 300), (7, 700), (8, 300), (9, 300), (10, 300))]
        pool = StreamPool(lanes, 48_000.0, block_size=T, blocks_per_step=M,
                          device=dev, profiles=[
                              PoolProfile(rs[0], _preset(1.0)),
                              PoolProfile(rs[1], None),
                              PoolProfile(rs[2], _preset(-2.0))])
        for g in range(G):
            pool.attach(g)
            pool.attach(g)
        pools.append((pool, rs))
    step = pools[0][0].step_frames
    outs = [[[] for _ in range(lanes)] for _ in pools]
    name = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    cols = []
    for rnd in range(12):
        fed = rng.random(lanes) < 0.8
        fed[0] = True              # lane 0 (group 0) fades at each swap
        fed[1] = not 4 <= rnd < 8  # lane 1 (group 0) pauses across both
        fed = np.nonzero(fed)[0]
        chunks = (rng.standard_normal((len(fed), 2, step)) * 0.3).astype(
            np.float32)
        for (pool, rs), out in zip(pools, outs):
            if rnd == 2:
                pool.set_equalizer(_preset(3.0), group=1)
            if rnd == 4:
                assert pool.set_renderer(rs[3], group=0) is True
                assert pool.set_renderer(rs[4], group=2) is True
            if rnd == 6:
                assert pool.set_renderer(rs[0], group=0) is True
                assert pool._fades[0].params.num_ears == 6
            mk.reset_launch_count()
            pool.push_many(fed, chunks)
            assert pool.pump() == 1
            if pool.device.type == "cuda":
                assert mk.launch_count(name) == G, rnd
                cols.append(sorted(k[1] for k, n in
                                   mk._launches_by_columns.items()
                                   for _ in range(n)))
            for j, y in zip(fed, pool.pull_many(fed, step)):
                out[j].append(y)
    assert [4 * M] * 3 in cols and [8 * M] * 3 in cols
    assert [8 * M, 8 * M, 12 * M] in cols
    for a, b in zip(*outs):
        assert rel_rms(np.concatenate(a, -1), np.concatenate(b, -1)) <= 1e-5


@pytest.mark.parametrize("M", [1, 8])
def test_three_half_fade_bank_on_card_matches_plain(cuda_device, M):
    """The three-half fade bank [original | intermediate | newest] of a
    4320-tap bank: its MAC operand (O = 12 through mac_kmajor's O = 12
    instance, equal to the generic kernel bit for bit; O = 96 through
    mac_kmajor_pages) against the plain version and
    float64 at the pool's 2048 lanes per group, and the ring MAC split into
    column runs when h[k] outgrows shared memory, against one plain
    contraction."""
    T, B = 512, 2048
    rng = np.random.default_rng(M)
    banks = [upols.make_conv_params(
        (rng.standard_normal((2, 2, 4320)) * 0.05).astype(np.float32), T,
        lookahead=M, device=cuda_device) for _ in range(3)]
    fade = upols.xfade_conv_params(banks[:2], banks[2])
    Kp = upols.padded_bin_count(T)
    P = fade.partition_count
    mk.reset_launch_count()
    if M == 1:
        h = upols._rotated_operand(upols.single_block_bank(fade, Kp), 3)
        fdl = torch.randn((Kp, h.shape[2], B), device=cuda_device)
        got = mk.mac_kmajor(fdl, h)
        plain = mk.mac_kmajor_ref(fdl, h)
        ref = mk.mac_kmajor_ref(fdl.double(), h.double())
        assert mk.launch_count("mac_kmajor", columns=12) == 1
        # O = 12 runs its own instance, bit for bit the generic kernel.
        assert torch.equal(got, mk.mac_kmajor(fdl, h, generic=True))
    else:
        bank = upols.paged_bank(fade, M, Kp)
        pages = [torch.randn((Kp, bank.shape[3], B), device=cuda_device)
                 for _ in range(P // M)]
        got = mk.mac_kmajor_pages(pages, bank)
        plain = mk.mac_kmajor_pages_ref(pages, bank)
        ref = mk.mac_kmajor_pages_ref([p.double() for p in pages],
                                      bank.double())
        assert mk.launch_count("mac_kmajor_pages", columns=96) == 1
    torch.cuda.synchronize()
    assert rel_rms(got.cpu().numpy(), plain.cpu().numpy()) <= 1e-6
    assert rel_rms(got.cpu().numpy(), ref.cpu().numpy()) <= 1e-6
    R = 600  # h[k] of 28 columns outgrows shared memory: two runs
    h = torch.randn((Kp, mk.max_columns(R) + 8, R), device=cuda_device)
    fdl = torch.randn((Kp, R, 128), device=cuda_device)
    mk.reset_launch_count()
    split = upols._mac_columns(fdl, h)
    assert mk.launch_count("mac_kmajor") == 2
    assert rel_rms(split.cpu().numpy(),
                   mk.mac_kmajor_ref(fdl, h).cpu().numpy()) <= 1e-6


def test_demo_on_card_reaches_processing(cuda_device, tmp_path, capsys):
    """`demo --seconds 1` on the card: "processing" on cuda:0, and one
    mac_kmajor launch per processed block (the graph's calls through the
    spatial engine)."""
    import json

    from airwave_tpu_torch.shell import app

    blocks = []
    build = app.build_demo

    def counting_build(*args, **kwargs):
        demo = build(*args, **kwargs)
        process = demo.spatial.engine.process_block

        def counted(x):
            blocks.append(x.shape)
            return process(x)

        demo.spatial.engine.process_block = counted
        return demo

    app.build_demo = counting_build
    mk.reset_launch_count()
    try:
        rc = app.main(["--data-dir", str(tmp_path / "d"), "demo",
                       "--seconds", "1"])
    finally:
        app.build_demo = build
    torch.cuda.synchronize()
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["device"] == "cuda:0"
    assert report["status"] == "processing" and report["spatial_ready"]
    assert blocks and mk.launch_count("mac_kmajor") == len(blocks)
    assert mk.launch_count("mac_kmajor_pages") == 0


def test_hrir_manager_activates_on_card(cuda_device, tmp_path):
    """A port HRIRManager with no device seeds the bundled presets and
    activates a renderer whose bank lies on cuda:0, equal to the one the
    CPU activation builds within 1e-6."""
    from airwave_tpu_torch.assets import bundled
    from airwave_tpu_torch.assets.eq_library import EqualizerManager
    from airwave_tpu_torch.assets.hrir_library import HRIRManager

    card = HRIRManager(str(tmp_path / "hrir"))
    bundled.seed_bundled_presets(EqualizerManager(str(tmp_path / "eq")), card,
                                 str(tmp_path / "staging"))
    preset = card.presets()[0]
    errors = []
    card.activate_preset(preset.id, 48_000.0, completion=errors.append)
    assert errors == [None] and card.device == cuda_device
    got = card.published_renderer.conv_params.Gflip2
    assert got.device == cuda_device
    cpu = HRIRManager(str(tmp_path / "hrir"), device="cpu")
    cpu.activate_preset(preset.id, 48_000.0)
    ref = cpu.published_renderer.conv_params.Gflip2
    assert rel_rms(got.cpu().numpy(), ref.numpy()) <= 1e-6


def test_feeder_on_card_equals_unstaged_loop(cuda_device):
    """The pinned double buffer on the copy stream: 8 blocks of distinct
    seeded data through DeviceFeeder at B=256 equal the unstaged loop
    (torch.from_numpy(x).to(dev), then the step) bit for bit."""
    import functools

    from airwave_tpu_torch.models.binaural import ChainState, chain_step_fn
    from airwave_tpu_torch.ops import eq_block
    from airwave_tpu_torch.runtime.feeder import DeviceFeeder

    rng = np.random.default_rng(11)
    B, S, T = 256, 2, 512
    hrir = (rng.standard_normal((S, 2, 4320)) * 0.05).astype(np.float32)
    params = upols.make_conv_params(hrir, T, device=cuda_device)
    eq = eq_block.unity_eq_params(T, device=cuda_device)
    step = functools.partial(chain_step_fn, params, eq, eq,
                             transition_length=960, spatial_enabled=True,
                             eq_enabled=True)

    def fresh():
        return ChainState(
            upols.make_conv_state(B, S, params.partition_count, T,
                                  cuda_device),
            eq_block.make_eq_state(B, device=cuda_device))

    blocks = [rng.standard_normal((B, S, T)).astype(np.float32)
              for _ in range(8)]
    state, want = fresh(), []
    for x in blocks:
        state, y = step(state, torch.from_numpy(x).to(cuda_device))
        want.append(y.cpu())
    feeder = DeviceFeeder(step, fresh(), device=cuda_device)
    mk.reset_launch_count()
    feeder.prime(blocks[0])
    got = [feeder.step(x) for x in blocks[1:]]
    got.append(feeder.flush())
    torch.cuda.synchronize()
    assert feeder.steps == 8 and mk.launch_count("mac_kmajor") == 8
    assert feeder.pinned_bytes == 2 * blocks[0].nbytes
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_calibration_per_lane_is_linear_in_the_probe(cuda_device):
    """cuda_pool_round_memory's per-lane bytes agree within 5% at probe
    batches 256 and 512, on both tiers, for every round kind."""
    from airwave_tpu_torch.utils.memory_planner import cuda_pool_round_memory

    wav = _wav(3, 4320)
    eq = bd.EqualizerDefinition(preamp_db=-3.0)
    for M in (1, 8):
        renderer = prepare_renderer(wav, channel_maps.STEREO, 48_000.0, 512,
                                    lookahead=M, device=cuda_device)
        cals = []
        for lanes in (256, 512):
            pool = StreamPool(lanes, 48_000.0, renderer, eq_definition=eq,
                              block_size=512, blocks_per_step=M,
                              device=cuda_device)
            cals.append(cuda_pool_round_memory(pool))
            del pool
        for kind in ("steady", "eq_xfade", "hotswap"):
            a, b = (c["rounds"][kind]["per_lane_bytes"] for c in cals)
            assert abs(a - b) <= 0.05 * b, (M, kind, a, b)
        assert cals[1]["backend"] == "cuda" and cals[1]["probe_batch"] == 512
        assert cals[1]["per_lane_bytes"] * 512 >= cals[1]["carry_bytes_exact"]


def test_plan_capacity_verify_fits_on_card(cuda_device):
    """plan_capacity --calibrate --verify on the card: the pool built at the
    recommendation peaks inside the planned budget, at an estimate over
    peak between 1 and the contract's 1.3."""
    from airwave_tpu_torch.tools import plan_capacity

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = plan_capacity.main(["--calibrate", "--verify", "--hbm-gb", "2",
                                   "--probe-batch", "256",
                                   "--device", str(cuda_device)])
    out = json.loads(buf.getvalue())
    assert code == 0 and out["calibrated"] is True
    verify = out["verify"]
    assert verify["fits"] and verify["max_streams"] == out["max_streams"]
    assert 1.0 <= verify["estimate_over_peak"] <= 1.3, verify


def test_round3_fixture_restores_and_continues_on_card(cuda_device):
    """The committed round-3 ring checkpoint migrates into a pool on
    cuda:0 and continues within 1e-5 of the same migration on the CPU and
    of the uninterrupted render (tests/test_migration.py:95)."""
    import os

    from airwave_tpu_torch.utils.checkpoint import load_pool_snapshot

    fixdir = os.path.join(os.path.dirname(__file__), "fixtures")
    d = np.load(os.path.join(fixdir, "r3_full_window_inputs.npz"))
    block = int(d["block"])
    n_pre, n_post = int(d["n_pre"]), int(d["n_post"])
    x = d["x"]

    def render(pool, lanes, streams, n_blocks):
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

    def build(device):
        renderer = prepare_renderer(WAVData(48_000.0, d["hrir_audio"]),
                                    channel_maps.STEREO, 48_000.0, block,
                                    device=device)
        return StreamPool(4, 48_000.0, renderer, block_size=block,
                          device=device)

    streams = [np.concatenate([x[0, :, :n_pre * block], d["extra_a"],
                               x[0, :, n_pre * block:]], axis=1),
               np.concatenate([x[1, :, :n_pre * block],
                               x[1, :, n_pre * block:]], axis=1)]
    ref = build("cpu")
    ref_out = render(ref, [ref.attach(), ref.attach()], streams,
                     max(s.shape[1] // block for s in streams))
    tails = [ref_out[0][:, (n_pre + 2) * block:], ref_out[1][:, n_pre * block:]]
    post = [x[j, :, n_pre * block:] for j in range(2)]
    conts = {}
    for device in ("cpu", cuda_device):
        pool = build(device)
        snap = load_pool_snapshot(os.path.join(fixdir, "r3_full_window_pool"),
                                  pool)
        assert snap["migrated_from"] == "full-window (schema 1)"
        pool.restore(snap)
        mk.reset_launch_count()
        conts[str(device)] = render(pool, snap["attached"], post, n_post)
        if device != "cpu":
            assert mk.launch_count("mac_kmajor") == n_post
    for j in range(2):
        got = conts[str(cuda_device)][j]
        assert rel_rms(got, conts["cpu"][j]) <= 1e-5
        assert rel_rms(got, tails[j]) <= 1e-5


def _sharded_pool_parity(devices, M, groups):
    """Drive a pool sharded over `devices` and the unsharded pool on
    cuda:0 with the same ragged traffic, a retarget and a hot-swap; returns
    (per-lane rel-RMS of the sharded output against the unsharded, MAC
    launches per round of the sharded pool, its rounds)."""
    from airwave_tpu_torch.parallel.mesh import make_mesh

    T, lanes = 64, 8 * groups
    wavs = [_wav(20 + g) for g in range(groups)]
    dev0 = torch.device("cuda", 0)
    kernel = "mac_kmajor_pages" if M > 1 else "mac_kmajor"

    def build(mesh):
        kw = dict(block_size=T, blocks_per_step=M,
                  device=None if mesh else dev0)
        rends = [prepare_renderer(w, channel_maps.STEREO, 48_000.0, T,
                                  lookahead=M, device=dev0) for w in wavs]
        if groups > 1:
            return StreamPool(lanes, 48_000.0, mesh=mesh, profiles=[
                PoolProfile(r, _preset(1.0 + g)) for g, r in enumerate(rends)],
                **kw)
        return StreamPool(lanes, 48_000.0, rends[0], _preset(2.0), mesh=mesh,
                          **kw)

    pools = [build(make_mesh(devices)), build(None)]
    for pool in pools:
        for lane in range(lanes):
            assert pool.attach(lane // 8) == lane
    swap = prepare_renderer(_wav(40), channel_maps.STEREO, 48_000.0, T,
                            lookahead=M, device=dev0)
    rng = np.random.default_rng(M + groups)
    step = pools[0].step_frames
    outs = [[[] for _ in range(lanes)] for _ in pools]
    launches, rounds = 0, 0
    for rnd in range(16):
        if rnd == 4:
            for pool in pools:
                pool.set_equalizer(_preset(-3.0), group=groups - 1)
        if rnd == 8:
            for pool in pools:
                pool.set_renderer(swap, group=0)
        fed = np.nonzero(rng.random(lanes) < 0.7)[0]
        chunks = (rng.standard_normal((len(fed), 2, step)) * 0.3).astype(
            np.float32)
        for pool, out in zip(pools, outs):
            pool.push_many(fed, chunks)
            mk.reset_launch_count()
            got = pool.pump()
            if pool is pools[0]:
                launches += mk.launch_count(kernel)
                rounds += got
            y = pool.pull_many(fed, step)
            for j, lane in enumerate(fed):
                out[lane].append(y[j])
    errs = [rel_rms(np.concatenate(a, -1), np.concatenate(b, -1))
            for a, b in zip(*outs)]
    return errs, launches, rounds


@pytest.mark.parametrize("M,groups", [(1, 1), (8, 1), (1, 2)])
def test_sharded_pool_on_card_matches_unsharded(cuda_device, M, groups):
    """A pool over 2 virtual shards of cuda:0 (each its own carry, kernel
    launches and CUDA stream) delivers the unsharded pool's audio within
    1e-6, one MAC launch per shard and group a round."""
    errs, launches, rounds = _sharded_pool_parity([cuda_device] * 2, M,
                                                  groups)
    assert rounds > 0 and launches == 2 * groups * rounds
    assert max(errs) <= 1e-6, errs


def test_sharded_pool_on_distinct_cards(cuda_device):
    """The same over two distinct cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    errs, launches, rounds = _sharded_pool_parity(["cuda:0", "cuda:1"], 1, 1)
    assert rounds > 0 and launches == 2 * rounds
    assert max(errs) <= 1e-6, errs
    assert torch.cuda.current_device() == 0


def test_launch_keeps_the_callers_device(cuda_device):
    """A launch on another card than the current one leaves the current
    device as it was (both kernels)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    rng = np.random.default_rng(5)
    fdl = torch.tensor(rng.standard_normal((24, 7, 300), dtype=np.float32),
                       device=other)
    h = torch.tensor(rng.standard_normal((24, 4, 7), dtype=np.float32),
                     device=other)
    bank = torch.stack([h, h])
    with torch.cuda.device(0):
        got = mk.mac_kmajor(fdl, h)
        assert torch.cuda.current_device() == 0
        paged = mk.mac_kmajor_pages([fdl, fdl], bank)
        assert torch.cuda.current_device() == 0
    torch.testing.assert_close(got, mk.mac_kmajor_ref(fdl, h))
    torch.testing.assert_close(paged, mk.mac_kmajor_pages_ref([fdl, fdl], bank))


def test_single_speaker_step_on_card_matches_cpu(cuda_device):
    """A one-speaker bank (a speaker shard's) through the single-block step
    on the card, every cursor, against the CPU."""
    rng = np.random.default_rng(11)
    hrir = (rng.standard_normal((1, 2, 300)) * 0.2).astype(np.float32)
    x = torch.tensor(rng.standard_normal((8, 5, 1, 64), dtype=np.float32))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        params = upols.make_conv_params(hrir, 64, device=dev)
        state = upols.make_conv_state(5, 1, params.partition_count, 64, dev)
        ys = []
        for xb in x.to(dev):
            state, y = upols.conv_step(params, state, xb)
            ys.append(y.cpu().numpy())
        outs.append(np.stack(ys))
    assert rel_rms(outs[0], outs[1]) <= 1e-6


def test_validation_ops_on_card_match_cpu_and_oracle(cuda_device):
    """ops/biquad_scan and resample_polyphase_device at their default
    device (the card): the scan over 5 blocks of 160 in float32 and
    float64 against the per-sample EQ oracle (float64 inside, float32 out:
    1e-4 as the CPU test, and 1e-7, that output's rounding, in float64)
    and against the same calls on the CPU (2e-4 in float32, where each
    side's roundoff is up to 1e-4 and the card's reductions group other
    terms than the CPU's; 1e-11 in float64), and a float64 impulse against
    tests/test_biquad_scan.py's golden values (1e-9); the device resampler
    against the CPU call and the float64 host resampler (2e-5)."""
    from airwave_tpu_torch.io.apo import (EqualizerDefinition,
                                          EqualizerFilter, FilterType)
    from airwave_tpu_torch.ops import biquad_scan, resample
    from airwave_tpu_torch.oracle.eq_oracle import EqCascadeOracle

    rng = np.random.default_rng(0)
    filters = [("PEAKING", 1_000, 6, 0.707), ("LOW_SHELF", 105, -2.8, 0.70),
               ("HIGH_SHELF", 10_000, -5.2, 0.70)]
    preamp, coeffs = bd.design_cascade(EqualizerDefinition(-2.0, tuple(
        EqualizerFilter(1, None, True, getattr(FilterType, t), f, g, q)
        for t, f, g, q in filters)), 48_000)
    B, T, n = 3, 160, 5
    x = (rng.standard_normal((B, 2, n * T)) * 0.5).astype(np.float32)
    oracle = np.stack([np.stack(EqCascadeOracle(coeffs, preamp, 48_000)
                                .process(x[b, 0], x[b, 1])) for b in range(B)])
    for dtype, tol, cpu_tol in ((torch.float32, 1e-4, 2e-4),
                                (torch.float64, 1e-7, 1e-11)):
        outs = []
        for where in ({}, {"device": "cpu"}):
            params = biquad_scan.make_scan_params(coeffs, preamp, dtype=dtype,
                                                  **where)
            state = biquad_scan.make_scan_state(B, dtype=dtype, **where)
            dev = params.A.device
            assert dev.type == ("cpu" if where else "cuda")
            assert state.device == dev
            ys = []
            for i in range(n):
                blk = torch.from_numpy(x[:, :, i * T:(i + 1) * T])
                state, y = biquad_scan.eq_scan_block(params, state,
                                                     blk.to(dev, dtype))
                ys.append(y.cpu().numpy())
            outs.append(np.concatenate(ys, -1))
        card, cpu = outs
        for b in range(B):
            assert rel_rms(card[b], oracle[b]) < tol, (dtype, b)
        assert rel_rms(card, cpu) <= cpu_tol, dtype
    preamp, coeffs = bd.design_cascade(EqualizerDefinition(0.0, tuple(
        EqualizerFilter(1, None, True, FilterType.PEAKING, f, g, q)
        for f, g, q in ((1_000, 6, 0.707), (3_000, -3, 1.1)))), 48_000)
    params = biquad_scan.make_scan_params(coeffs, preamp, dtype=torch.float64)
    impulse = torch.zeros((1, 2, 6), dtype=torch.float64, device=cuda_device)
    impulse[0, 0, 0] = 1.0
    _, y = biquad_scan.eq_scan_block(
        params, biquad_scan.make_scan_state(1, dtype=torch.float64), impulse)
    golden = [1.007962105198731, 0.026656172367575, 0.046848317472827,
              0.062845911221200, 0.072328817552935, 0.074696369241889]
    np.testing.assert_allclose(y[0, 0].cpu().numpy(), golden, rtol=0,
                               atol=1e-9)

    x = rng.standard_normal((3, 2, 2205)).astype(np.float32) * 0.5
    card = resample.resample_polyphase_device(x, 44_100.0, 48_000.0)
    assert card.device.type == "cuda"
    cpu = resample.resample_polyphase_device(x, 44_100.0, 48_000.0,
                                             device="cpu")
    host = np.stack([np.stack([
        resample.resample_polyphase(x[b, c], 44_100.0, 48_000.0)
        for c in range(2)]) for b in range(3)])
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(card.cpu().numpy(), host, rtol=0, atol=2e-5)


# --- The precision tiers (ops/precision) -------------------------------------


@pytest.mark.parametrize("tier", ["high", "default"])
@pytest.mark.parametrize("a_shape,b_shape", [
    ((1026, 512), (512, 16384)),       # the paged analysis, 2 lanes' worth
    ((640, 1040), (4, 1040, 2048)),    # the folded paged synthesis
])
def test_tier_route_matches_plain(cuda_device, tier, a_shape, b_shape):
    """The tier's route (bf16 operands, fp32 accumulation and output on the
    tensor cores) against its plain version, the same split operands in
    fp32: one launch, within K * 2^-29 rel-RMS for one pass's depth K (the
    tensor cores truncate each k-step's sum into the fp32 accumulator, so
    the two differ by about K * 2^-30: 1.04e-6 at K=1040 here)."""
    from airwave_tpu_torch.ops import precision

    rng = np.random.default_rng(sum(a_shape) + sum(b_shape))
    a = torch.tensor(rng.standard_normal(a_shape), dtype=torch.float32,
                     device=cuda_device)
    b = torch.tensor(rng.standard_normal(b_shape), dtype=torch.float32,
                     device=cuda_device)
    A, B = precision.operand(a, "a", tier), precision.operand(b, "b", tier)
    precision.reset_launch_count()
    got = precision.product(A, B)
    torch.cuda.synchronize()
    assert precision.launch_count() == 1
    assert got.dtype == torch.float32
    plain = torch.matmul(A.float(), B.float())
    tol = a_shape[1] * 2.0 ** -29
    assert rel_rms(got.cpu().numpy(), plain.cpu().numpy()) <= tol
    bound = 1e-5 if tier == "high" else 1e-2
    exact = (a.double() @ b.double()).cpu().numpy()
    assert rel_rms(got.cpu().numpy(), exact) <= bound


def test_paged_chain_tiers_against_oracle(cuda_device, monkeypatch):
    """The paged chain (tools/validate_accuracy --blocks-per-step 8) on the
    card at each tier, set on the module constants the sites read: high
    within 1e-4 of the port's float64 oracles and above highest's error,
    one bf16 pass over 1e-4; relaxed products ran, and the process-wide
    strict fp32 policy still holds after them."""
    from airwave_tpu_torch.device import precision_is_strict
    from airwave_tpu_torch.ops import eq_block, fftmm, precision, upols
    from airwave_tpu_torch.tools import validate_accuracy

    errors, products = {}, {}
    for tier in ("highest", "high", "default"):
        with monkeypatch.context() as m:
            for module in (fftmm, upols, eq_block):
                m.setattr(module, "PRECISION", tier)
            m.setattr(fftmm, "DFT_PRECISION", tier)
            precision.reset_launch_count()
            result = validate_accuracy.validate(
                ["--blocks-per-step", "8", "--blocks", "16",
                 "--device", str(cuda_device)])
            products[tier] = precision.launch_count()
        errors[tier] = result["value"]
    assert errors["highest"] <= 1e-5, errors
    assert errors["highest"] < errors["high"] <= 1e-4, errors
    assert errors["default"] > 1e-4, errors
    assert products["highest"] == 0 and products["high"] > 0, products
    assert precision_is_strict()


@pytest.mark.parametrize("crossfade", [False, True])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_eq_step_lanes_last_on_card(cuda_device, monkeypatch, tier,
                                    crossfade):
    """eq_step at 8,192 lanes on the card, handed the [B, C, T] view of a
    contiguous [C, T, B] block as conv_step returns it, at each tier (set
    on the module constant the products read): the lanes-last route ran,
    with relaxed products at the relaxed tiers alone; y and both states
    within 1e-6 rel-RMS of the float64 step at highest (and of the rows
    route on the same card), 1e-5 at high, 1e-2 for one bf16 pass; the
    state came back a contiguous [B, C, N]."""
    from airwave_tpu_torch.ops import eq_block, precision

    B, T, N = 8192, 512, 128
    rng = np.random.default_rng(18)

    def eq_params(gain):
        preamp, coeffs = bd.design_cascade(_preset(gain), 48_000.0)
        return eq_block.make_eq_params(coeffs, preamp, T, N,
                                       device=cuda_device)

    params = [eq_params(4.0), eq_params(-6.0)]
    lanes = [torch.tensor(rng.standard_normal(shape) * scale,
                          dtype=torch.float32, device=cuda_device)
             for shape, scale in (((2, T, B), 0.5), ((B, 2, N), 0.1),
                                  ((B, 2, N), 0.1))]
    counter = torch.tensor(rng.integers(0, 1200, B), dtype=torch.int32,
                           device=cuda_device)
    x = lanes[0].permute(2, 0, 1)
    state = eq_block.EqState(lanes[1], lanes[2], counter)

    def step(p, s, xb):
        return eq_block.eq_step(p[0], p[1], s, xb, 960, crossfade)

    wide = [eq_block.EqParams(*(a.double().cpu() for a in p)) for p in params]
    ref_state, ref_y = step(wide, eq_block.EqState(
        *(a.double().cpu() for a in state[:2]), counter.cpu()),
        x.double().cpu().contiguous())
    with monkeypatch.context() as m:
        m.setattr(eq_block, "PRECISION", tier)
        precision.reset_launch_count()
        eq_block.reset_route_counts()
        got_state, y = step(params, state, x)
        torch.cuda.synchronize()
        assert eq_block.route_counts() == {"lanes_last": 1, "rows": 0}
        assert precision.launch_count() == (
            0 if tier == "highest" else 8 if crossfade else 4)
        rows_state, rows_y = step(params, state, x.contiguous())
    bound = {"highest": 1e-6, "high": 1e-5, "default": 1e-2}[tier]
    for got, want in ((y, ref_y), (got_state.s_to, ref_state.s_to),
                      (got_state.s_from, ref_state.s_from)):
        if want.abs().max() > 0:
            assert rel_rms(got.cpu().numpy(), want.numpy()) <= bound
    for s in got_state[:2]:
        assert s.shape == (B, 2, N) and s.is_contiguous()
    assert y.permute(1, 2, 0).is_contiguous()
    if tier == "highest":
        assert rel_rms(y.cpu().numpy(), rows_y.cpu().numpy()) <= 1e-6
        assert rel_rms(got_state.s_to.cpu().numpy(),
                       rows_state.s_to.cpu().numpy()) <= 1e-6


@pytest.mark.parametrize("blocks_per_step", [1, 8])
def test_soak_on_card_passes(cuda_device, blocks_per_step):
    """tools/soak on each tier at B=1024 for 5 s: every checksum finite, no
    drift, live device bytes flat over the window, the tier's kernel
    launched once per round."""
    from airwave_tpu_torch.tools import soak

    pool = soak.build_pool(1024, blocks_per_step=blocks_per_step,
                           device=cuda_device)
    mk.reset_launch_count()
    result = soak.soak(pool, soak.device_input(pool), 5.0, 64)
    assert result["pass"] is True, result
    assert result["calls"] >= 2
    for key in ("device_requested_bytes", "device_live_allocations"):
        assert result[f"{key}_end"] == result[f"{key}_baseline"], key
    name = "mac_kmajor_pages" if blocks_per_step > 1 else "mac_kmajor"
    rounds = (result["calls"] + 2) * 64 // blocks_per_step
    assert mk.launch_count(name) == rounds


def test_checkpoint_scale_on_card_round_trips(cuda_device, tmp_path):
    """tools/checkpoint_scale at B=1024, M=8 on the card: the carry saved,
    loaded and restored into a fresh pool equals the live one bit for
    bit."""
    from airwave_tpu_torch.tools import checkpoint_scale

    result = checkpoint_scale.measure(batch=1024, blocks_per_step=8,
                                      out=str(tmp_path / "ckpt"),
                                      device=cuda_device)
    assert result["roundtrip_exact"] is True, result
    assert result["carry_gib"] > 0.1 and result["pump_stall_ms"] > 0
    assert list(tmp_path.iterdir()) == []
