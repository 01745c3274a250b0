"""Tests of the PyTorch port that need a CUDA card (marker `cuda`; they skip
without one). This file imports no jax, so it runs on a machine with a card
and no jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from airwave_tpu_torch.kernels import mac_kmajor as mk
from airwave_tpu_torch.models.bake import bake
from airwave_tpu_torch.ops import biquad_design as bd

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
