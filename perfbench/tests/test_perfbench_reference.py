"""The frozen reference: its parts against independent readings, and the
program's chain against it at the tiny sizes on the CPU, on both chain
tiers, each cell at its configuration's precision tier, with and without
the EQ."""

import numpy as np
import pytest
import torch

from conftest import CELLS, run_tiny
from perfbench.core.cell import run_cell
from perfbench.core.spec import Spec

ref = Spec().reference("binaural")
# The worst reading at the tiny sizes on the CPU: a fifth of the tier's
# contract (1e-5 at "highest", 1e-4 at "high", where the tiny copy keeps
# the block).
AGREES = {"highest": 2e-6, "high": 2e-5}


def test_channel_map_is_the_production_hesuvi_order():
    from airwave_tpu_torch.assets import channel_maps

    m = channel_maps.hesuvi_14_channel(channel_maps.STEREO.channels)
    assert ref.speaker_channels("stereo") == [m.indices("FL"),
                                              m.indices("FR")]


@pytest.mark.parametrize("kind", ["peaking", "low_shelf", "high_shelf"])
def test_rbj_against_the_analytic_gain(kind):
    """|H| at the shelf's far end or the peak's centre is the gain."""
    fs, f0, gain = 48000.0, 1000.0, 6.0
    b0, b1, b2, a1, a2 = ref.rbj_biquad(kind, f0, gain, 0.7071, fs)
    w = {"peaking": 2 * np.pi * f0 / fs, "low_shelf": 1e-6,
         "high_shelf": np.pi - 1e-6}[kind]
    z = np.exp(-1j * w)
    h = (b0 + b1 * z + b2 * z * z) / (1 + a1 * z + a2 * z * z)
    assert 20 * np.log10(abs(h)) == pytest.approx(gain, abs=1e-6)


def test_eq_impulse_decays_and_matches_its_transfer_function():
    eq = {"preamp_db": -2.5, "filters": [
        {"type": "peaking", "frequency_hz": 160.0, "gain_db": 2.0, "q": 0.9},
        {"type": "low_shelf", "frequency_hz": 260.0, "gain_db": -2.0,
         "q": 0.9}]}
    h = ref.eq_impulse(eq, 48000.0)
    n = len(h)
    freqs = np.fft.rfftfreq(n, 1 / 48000.0)
    got = np.fft.rfft(h)
    want = np.full(freqs.shape, 10 ** (-2.5 / 20), complex)
    z = np.exp(-2j * np.pi * freqs / 48000.0)
    for f in eq["filters"]:
        b0, b1, b2, a1, a2 = ref.rbj_biquad(f["type"], f["frequency_hz"],
                                            f["gain_db"], f["q"], 48000.0)
        want *= (b0 + b1 * z + b2 * z * z) / (1 + a1 * z + a2 * z * z)
    assert np.abs(got - want).max() < 1e-9


def test_render_is_the_direct_convolution():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2, 2, 37))
    x = rng.standard_normal((3, 2, 100))
    y = ref.render(torch.from_numpy(g), torch.from_numpy(x), 20).numpy()
    for n in range(3):
        for e in range(2):
            full = sum(np.convolve(x[n, s], g[s, e]) for s in range(2))
            np.testing.assert_allclose(y[n, e], full[80:100], atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_program_agrees_with_the_reference(tiny_spec, cell, seed):
    result, checks = run_tiny(tiny_spec, cell, seed, 0.2, False)
    tier = tiny_spec.config(tiny_spec.cell(cell)["config"])["tier"]
    worst = checks[0]
    assert worst.name == "worst_rel_rms" and worst.value < AGREES[tier]
    assert result["correct"] is True


def test_program_agrees_on_the_paged_tier_without_the_eq(tiny_spec):
    """Not a cell: the bake tier with the EQ off, against the reference."""
    import copy

    spec = copy.copy(tiny_spec)
    original = spec.traffic

    def traffic(name):
        t = original(name)
        return dict(t, eq_enabled=False) if name == "closed.eq.b16384" else t

    spec.traffic = traffic
    result, checks = run_cell(spec, "bake.eq.b16384", 9, 0.2, False, "cpu")
    assert result["correct"] is True and checks[0].value < 2e-6
