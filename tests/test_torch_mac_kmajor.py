"""kernels/mac_kmajor of the PyTorch port: the plain version against the JAX
Pallas kernel (interpret mode) and the JAX paged MAC, the wrapper's checks
and the build's failure without nvcc. The CUDA kernel itself is tested in
test_torch_cuda.py."""

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


def test_accumulated_pages_match_jax_paged_mac():
    """Three pages at R = S*C*M = 32, O = M*E*Q = 32 (M = 8), accumulated in
    one [O, Kp, B] buffer, against the JAX step's _paged_mac output
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
    pages = tuple(torch.tensor(np.asarray(pg)) for pg in sj.pages)
    got = tupols._paged_mac(pages, bank, M)                  # [M, E, Q, Kp, B]
    ref = np.asarray(ykm).reshape(Kp, B, M, 2, 2).transpose(2, 3, 4, 0, 1)
    assert rel_rms(got.numpy(), ref) <= 1e-6


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


def test_cpu_launches_nothing():
    mk.reset_launch_count()
    mk.mac_kmajor(torch.zeros((8, 2, 3)), torch.zeros((8, 4, 2)))
    assert mk.launch_count() == 0


def test_build_raises_without_nvcc(monkeypatch):
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        mk.build()
