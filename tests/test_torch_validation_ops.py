"""The validation-only ops of the PyTorch port against the JAX package:
ops/biquad_scan.eq_scan_block (tests/test_biquad_scan.py's three cases)
and the polyphase half of ops/resample (tests/test_resample.py's three
polyphase cases). Each case runs the JAX function and the port's on the
same seeded inputs, on the CPU, and holds the port to the JAX test's own
bound, and to the JAX output within the stated tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.io.apo import EqualizerDefinition as JDefinition
from airwave_tpu.io.apo import EqualizerFilter as JFilter
from airwave_tpu.io.apo import FilterType as JType
from airwave_tpu.ops import biquad_design as jbd
from airwave_tpu.ops import biquad_scan as jscan
from airwave_tpu.ops import resample as jresample
from airwave_tpu.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu_torch.io.apo import EqualizerDefinition as TDefinition
from airwave_tpu_torch.io.apo import EqualizerFilter as TFilter
from airwave_tpu_torch.io.apo import FilterType as TType
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.ops import biquad_scan as tscan
from airwave_tpu_torch.ops import resample as tresample

SCAN_F32_TOL = 1e-4   # tests/test_biquad_scan.py: f32 scan vs the oracle
GOLDEN_TOL = 1e-9     # tests/test_biquad_scan.py: f64 scan vs golden values
RESAMPLE_TOL = 2e-5   # tests/test_resample.py: device vs host polyphase


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


def designs(filters, preamp_db=0.0):
    """(JAX design, port design) of one definition: (preamp, coeffs)."""
    j = jbd.design_cascade(JDefinition(preamp_db, tuple(
        JFilter(1, None, True, getattr(JType, t), f, g, q)
        for t, f, g, q in filters)), 48_000)
    t = tbd.design_cascade(TDefinition(preamp_db, tuple(
        TFilter(1, None, True, getattr(TType, t), f, g, q)
        for t, f, g, q in filters)), 48_000)
    return j, t


def run_both(filters, preamp_db, x, T, dtype):
    """Both scans over x [B, C, n] in blocks of T: (JAX out, port out)."""
    (jp, jc), (tp, tc) = designs(filters, preamp_db)
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == np.float64
                else (jnp.float32, torch.float32))
    jparams = jscan.make_scan_params(jc, jp, dtype=jdt)
    tparams = tscan.make_scan_params(tc, tp, dtype=tdt, device="cpu")
    jstate = jscan.make_scan_state(x.shape[0], dtype=jdt)
    tstate = tscan.make_scan_state(x.shape[0], dtype=tdt, device="cpu")
    step = jax.jit(jscan.eq_scan_block)
    jout, tout = [], []
    for i in range(x.shape[-1] // T):
        blk = x[:, :, i * T:(i + 1) * T]
        jstate, y = step(jparams, jstate, jnp.asarray(blk))
        jout.append(np.asarray(y))
        tstate, y = tscan.eq_scan_block(tparams, tstate, torch.from_numpy(blk))
        tout.append(y.numpy())
    return np.concatenate(jout, -1), np.concatenate(tout, -1), (jc, jp)


def test_scan_cascade_matches_oracle_multi_block():
    """Three filters at a block of 160 (not a power of two) over 5 blocks:
    in float32 the port is within the JAX test's 1e-4 of the per-sample
    float64 oracle, as the JAX scan is (the two f32 scans take different
    trees, so their roundoff differs by about that much); in float64 the
    port matches the JAX scan within 1e-9."""
    rng = np.random.default_rng(0)
    filters = [("PEAKING", 1_000, 6, 0.707), ("LOW_SHELF", 105, -2.8, 0.70),
               ("HIGH_SHELF", 10_000, -5.2, 0.70)]
    B, T = 3, 160
    x = (rng.standard_normal((B, 2, 5 * T)) * 0.5).astype(np.float32)
    jout, tout, (coeffs, preamp) = run_both(filters, -2.0, x, T, np.float32)
    for b in range(B):
        oracle = EqCascadeOracle(coeffs, preamp, 48_000)
        ref = np.stack(oracle.process(x[b, 0], x[b, 1]))
        assert rel_rms(tout[b], ref) < SCAN_F32_TOL, b
        assert rel_rms(jout[b], ref) < SCAN_F32_TOL, b
    j64, t64, _ = run_both(filters, -2.0, x.astype(np.float64), T,
                           np.float64)
    assert rel_rms(t64, j64) < 1e-9


def test_scan_matches_golden_impulse():
    """Float64: the port hits the JAX test's golden impulse response to
    1e-9, and the JAX scan to 1e-12."""
    filters = [("PEAKING", 1_000, 6, 0.707), ("PEAKING", 3_000, -3, 1.1)]
    x = np.zeros((1, 2, 6), np.float64)
    x[0, 0, 0] = 1.0
    jout, tout, _ = run_both(filters, 0.0, x, 6, np.float64)
    expected = [1.007962105198731, 0.026656172367575, 0.046848317472827,
                0.062845911221200, 0.072328817552935, 0.074696369241889]
    np.testing.assert_allclose(tout[0, 0], expected, rtol=0, atol=GOLDEN_TOL)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-12)


def test_scan_unity_padding_is_exact_passthrough():
    x = np.random.default_rng(1).standard_normal((1, 2, 64)).astype(np.float32)
    jout, tout, _ = run_both([], 0.0, x, 64, np.float32)
    np.testing.assert_array_equal(tout, x)
    np.testing.assert_array_equal(tout, jout)


def _tone(freq, rate, n):
    return np.sin(2 * np.pi * freq * np.arange(n) / rate)


def test_design_and_host_polyphase_equal_jax():
    """The filter bank design is the JAX package's to the bit, and the host
    resampler's output with it."""
    for rates in ((44_100.0, 48_000.0), (48_000.0, 44_100.0),
                  (96_000.0, 48_000.0)):
        j, t = jresample.design_polyphase(*rates), tresample.design_polyphase(*rates)
        assert j[:2] == t[:2]
        np.testing.assert_array_equal(j[2], t[2])
    x = np.random.default_rng(3).standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_array_equal(
        tresample.resample_polyphase(x, 44_100.0, 48_000.0),
        jresample.resample_polyphase(x, 44_100.0, 48_000.0))


@pytest.mark.parametrize("impl", ["host", "device"])
def test_polyphase_tone_fidelity_44k_to_48k(impl):
    """A 1 kHz tone resampled 44.1k -> 48k stays a clean 1 kHz tone (the
    JAX test's bounds); the device path on the CPU matches the JAX device
    path within 2e-5."""
    n = 4410 * 2
    x = _tone(1_000.0, 44_100.0, n).astype(np.float32)
    if impl == "host":
        y = tresample.resample_polyphase(x, 44_100.0, 48_000.0)
    else:
        y = tresample.resample_polyphase_device(x, 44_100.0, 48_000.0,
                                                device="cpu").numpy()
        want = np.asarray(jresample.resample_polyphase_device(
            x, 44_100.0, 48_000.0))
        np.testing.assert_allclose(y, want, rtol=0, atol=RESAMPLE_TOL)
    expected = _tone(1_000.0, 48_000.0, len(y))
    margin = 200
    err = y[margin:-margin] - expected[margin:-margin]
    rel = np.sqrt(np.mean(err ** 2)) / np.sqrt(np.mean(expected ** 2))
    assert rel < 1e-3, rel
    seg = y[margin:-margin] * np.hanning(len(y) - 2 * margin)
    spec = np.abs(np.fft.rfft(seg))
    peak_bin = int(np.argmax(spec))
    spec[max(0, peak_bin - 8): peak_bin + 8] = 0
    assert np.max(spec) < 1e-3 * np.max(np.abs(np.fft.rfft(seg)))


def test_polyphase_device_matches_host_and_batches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 2205)).astype(np.float32) * 0.5
    host = np.stack([np.stack([
        tresample.resample_polyphase(x[b, c], 44_100.0, 48_000.0)
        for c in range(2)]) for b in range(3)])
    device = tresample.resample_polyphase_device(x, 44_100.0, 48_000.0,
                                                 device="cpu").numpy()
    assert device.shape == host.shape
    np.testing.assert_allclose(device, host, atol=RESAMPLE_TOL)
    np.testing.assert_allclose(
        device, np.asarray(jresample.resample_polyphase_device(
            x, 44_100.0, 48_000.0)), rtol=0, atol=RESAMPLE_TOL)


def test_linear_vs_polyphase_quality_gap():
    """The polyphase path beats linear interpolation tenfold on a high
    tone."""
    n = 44_100
    x = _tone(15_000.0, 44_100.0, n).astype(np.float32)
    lin = tresample.resample_linear(x, 44_100.0, 48_000.0)
    poly = tresample.resample_polyphase(x, 44_100.0, 48_000.0)
    expected = _tone(15_000.0, 48_000.0, min(len(lin), len(poly)))

    def rel_err(y):
        m = 300
        e = y[m:len(expected) - m] - expected[m:len(expected) - m]
        return np.sqrt(np.mean(e ** 2))

    assert rel_err(poly) < rel_err(lin) / 10
    np.testing.assert_array_equal(
        poly, jresample.resample_polyphase(x, 44_100.0, 48_000.0))


def test_device_defaults_to_the_card():
    """make_scan_params, make_scan_state and the device resampler ask for
    the card by default; without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would run")
    for call in (lambda: tscan.make_scan_params([], 1.0),
                 lambda: tscan.make_scan_state(1),
                 lambda: tresample.resample_polyphase_device(
                     np.zeros(64, np.float32), 44_100.0, 48_000.0)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
