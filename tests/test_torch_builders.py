"""Host-side builders of the PyTorch port equal the JAX package's bit for bit:
biquad design and block state-space lowering, the DFT weights, the UPOLS
filter bank and the EQ matrices. Then the fp32 DFT matmuls against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.io import apo as japo
from airwave_tpu.ops import biquad_design as jbd
from airwave_tpu.ops import eq_block as jeq
from airwave_tpu.ops import fftmm as jfftmm
from airwave_tpu.ops import upols as jupols
from airwave_tpu.utils import errors as jerrors
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import eq_block as teq
from airwave_tpu_torch.ops import fftmm as tfftmm
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.utils import errors as terrors

# The same preset parsed by each package's own parser: the port is never
# handed a definition of the JAX package.
PRESET = b"""Preamp: -2.56 dB
Filter 1: ON LSC Fc 105 Hz Gain -2.8 dB Q 0.70
Filter 2: ON PK Fc 894.2 Hz Gain 2.0 dB Q 1.24
Filter 3: OFF PK Fc 2000 Hz Gain 3.0 dB Q 1.0
Filter 4: ON PK Fc 6165.4 Hz Gain 2.3 dB Q 5.37
Filter 5: ON HSC Fc 10000 Hz Gain -5.2 dB Q 0.70
"""
DEFINITION = tapo.parse(PRESET, "preset")
DEFINITION_JAX = japo.parse(PRESET, "preset")


def _equal(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def test_design_cascade_and_block_ssm_bit_identical():
    pre_t, co_t = tbd.design_cascade(DEFINITION, 48_000.0)
    pre_j, co_j = jbd.design_cascade(DEFINITION_JAX, 48_000.0)
    assert pre_t == pre_j
    assert [c.as_array().tolist() for c in co_t] == \
        [c.as_array().tolist() for c in co_j]
    for T, n in ((64, 128), (512, 128), (64, 16)):
        st = tbd.block_ssm(co_t, pre_t, T, n)
        sj = jbd.block_ssm(co_j, pre_j, T, n)
        for f in ("h", "O", "A_T", "G"):
            _equal(getattr(st, f), getattr(sj, f))


def test_design_errors_match():
    """Each package raises its own error class of the same name on the
    same bad input."""
    for bd, apo, errors in ((tbd, tapo, terrors), (jbd, japo, jerrors)):
        bad = apo.EqualizerDefinition(0.0, (apo.EqualizerFilter(
            1, None, True, apo.FilterType.PEAKING, 30_000.0, 1.0, 1.0),))
        with pytest.raises(errors.EqInvalidFilter):
            bd.design_cascade(bad, 48_000.0)
        with pytest.raises(errors.EqInvalidSampleRate):
            bd.design_cascade(None, 0.0)
        with pytest.raises(errors.InvalidQ):
            bd.make_biquad(apo.FilterType.PEAKING, 1.0, 1000.0, 0.0, 48_000.0)
        big = bd.make_biquad(apo.FilterType.PEAKING, 1.0, 1000.0, 1.0,
                             48_000.0)
        with pytest.raises(errors.EqTooManyFilters):
            bd.block_ssm([big] * 3, 1.0, 64, state_dim=4)


@pytest.mark.parametrize("n", [128, 1024])
def test_dft_weights_bit_identical(n):
    _equal(tfftmm._rfft_weights_np(n), jfftmm._rfft_weights_np(n))
    _equal(tfftmm._irfft_weights_np(n, n // 2, n // 2),
           jfftmm._irfft_weights_np(n, n // 2, n // 2))
    _equal(tfftmm.rfft_weights_half(n, device="cpu"),
           jfftmm.rfft_weights_half(n))
    _equal(tfftmm.irfft_weights(n, 0, n, device="cpu"),
           jfftmm.irfft_weights(n, 0, n))


def test_rfft_irfft_mm_match_jax():
    rng = np.random.default_rng(5)
    n = 128
    x = rng.standard_normal((3, 2, n)).astype(np.float32)
    wf = tfftmm.rfft_weights_half(n, device="cpu")
    wi = tfftmm.irfft_weights(n, 0, n, device="cpu")
    u_t = tfftmm.rfft_mm(torch.from_numpy(x[..., : n // 2]), wf).numpy()
    u_j = np.asarray(jfftmm.rfft_mm(jnp.asarray(x[..., : n // 2]),
                                    jfftmm.rfft_weights_half(n)))
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-5)
    full = np.fft.rfft(np.concatenate([x[..., : n // 2], 0 * x[..., : n // 2]], -1))
    np.testing.assert_allclose(u_t[..., 0] + 1j * u_t[..., 1], full, atol=1e-4)
    planes = np.stack([full.real, full.imag], -1).astype(np.float32)
    y_t = tfftmm.irfft_mm(torch.from_numpy(planes), wi).numpy()
    y_j = np.asarray(jfftmm.irfft_mm(jnp.asarray(planes),
                                     jfftmm.irfft_weights(n, 0, n)))
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y_t[..., : n // 2], x[..., : n // 2], atol=1e-5)


@pytest.mark.parametrize(
    "length,pow2,lookahead,partitions",
    [
        (300, True, 1, None),
        (300, False, 1, None),
        (300, True, 4, None),
        (300, False, 4, None),
        (5 * 64 + 13, False, 8, None),
        (300, False, 1, 12),
        (300, True, 4, 16),
        (1, True, 1, None),
    ],
)
def test_make_conv_params_bit_identical(length, pow2, lookahead, partitions):
    rng = np.random.default_rng(length + lookahead)
    hrir = (rng.standard_normal((2, 2, length)) * 0.3).astype(np.float32)
    pt = tupols.make_conv_params(hrir, 64, pad_to_pow2=pow2,
                                 lookahead=lookahead, partitions=partitions,
                                 device="cpu")
    pj = jupols.make_conv_params(hrir, 64, pad_to_pow2=pow2,
                                 lookahead=lookahead, partitions=partitions)
    for a, b in zip(pt, pj):
        _equal(a, b)
    assert pt.partition_count == pj.partition_count
    assert (pt.num_speakers, pt.num_ears, pt.num_bins) == \
        (pj.num_speakers, pj.num_ears, pj.num_bins)
    assert tupols.padded_bin_count(64) == jupols.padded_bin_count(64)


@pytest.mark.parametrize("lookahead,partitions", [(1, 3), (4, 10), (4, 8)])
def test_make_conv_params_rejects_what_jax_rejects(lookahead, partitions):
    hrir = np.ones((2, 2, 300), np.float32)
    with pytest.raises(ValueError) as jerr:
        jupols.make_conv_params(hrir, 64, lookahead=lookahead,
                                partitions=partitions)
    with pytest.raises(ValueError) as terr:
        tupols.make_conv_params(hrir, 64, lookahead=lookahead,
                                partitions=partitions, device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("T,state_dim", [(64, 128), (512, 128), (64, 32)])
def test_make_eq_params_bit_identical(T, state_dim):
    pre, co = tbd.design_cascade(DEFINITION, 48_000.0)
    pt = teq.make_eq_params(co, pre, T, state_dim, device="cpu")
    pj = jeq.make_eq_params(co, pre, T, state_dim)
    for a, b in zip(pt, pj):
        _equal(a, b)
    for a, b in zip(teq.unity_eq_params(T, state_dim, device="cpu"),
                    jeq.unity_eq_params(T, state_dim)):
        _equal(a, b)
    assert teq.COUNTER_IDLE == int(jeq.COUNTER_IDLE)
