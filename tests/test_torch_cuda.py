"""Tests of the PyTorch port that need a CUDA card (marker `cuda`; they skip
without one). This file imports no jax, so it runs on a machine with a card
and no jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

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
from airwave_tpu_torch.runtime.stream_pool import StreamPool

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
    (2, 24, 12, 96, 130),     # three passes, rows by 4-byte copies
    (4, 16, 7, 64, 5),        # ragged R and B
])
def test_pages_kernel_wide_columns_equal_narrow(cuda_device, n, K, R, O, B):
    """O a multiple of 32 takes 32 columns per pass over the pages: bit for
    bit what 16 columns per pass (twice the passes) gives, within 1e-6 of
    float64, one launch."""
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


def test_kernel_rejects_non_contiguous(cuda_device):
    fdl = torch.zeros((8, 5, 6), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mac_kmajor(fdl, torch.zeros((8, 4, 6), device=cuda_device))


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
