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


def test_kernel_rejects_non_contiguous(cuda_device):
    fdl = torch.zeros((8, 5, 6), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mac_kmajor(fdl, torch.zeros((8, 4, 6), device=cuda_device))


@pytest.mark.parametrize("M", [1, 4])
def test_bake_on_card_matches_cpu(cuda_device, M):
    """The whole bake on the card (kernel launched) equals the CPU bake
    (plain version) at a tiny size, batch not a multiple of the CTA width."""
    rng = np.random.default_rng(M)
    hrir = (rng.standard_normal((2, 2, 300)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((5, 2, 9 * 64 + 7)) * 0.4).astype(np.float32)
    preamp, coeffs = bd.design_cascade(None, 48_000.0)
    mk.reset_launch_count()
    y_gpu, state = bake(hrir, x, 48_000.0, coeffs, preamp, block_size=64,
                        blocks_per_step=M, device=cuda_device)
    assert mk.launch_count() > 0
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
    """The serving pool on the card (kernel launched, pinned staging,
    deferred delivery) against the same pool on the CPU, at 5 lanes (not a
    multiple of the kernel's 256-lane tile), with ragged traffic, a
    retarget and a detach and re-attach."""
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
            assert pool.pump() == (1 if len(fed) else 0)
            y = pool.pull_many(fed, step)
            for j, lane in enumerate(fed):
                out[lane].append(y[j])
    assert mk.launch_count() > 0
    assert pools[0].stats()["debt_rolls"] > 0
    for a, b in zip(*outs):
        assert rel_rms(np.concatenate(a, -1), np.concatenate(b, -1)) <= 1e-5
