"""graph/renderer of the PyTorch port against the JAX package: the same
14-channel HRIR WAV, written once and loaded by each package's own loader,
prepares bit-identical conv params and the same input selection."""

import io

import numpy as np
import pytest
import torch

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph import renderer as jren
from airwave_tpu.io import wav as jwav
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph import renderer as tren
from airwave_tpu_torch.io import wav as twav

BLOCK = 64


def _wav_bytes(rate=48_000.0, channels=14, frames=300, seed=6):
    audio = (np.random.default_rng(seed).standard_normal((channels, frames))
             * 0.2).astype(np.float32)
    buf = io.BytesIO()
    twav.save(buf, audio, rate)
    return buf.getvalue()


def _both(blob, layout, **kw):
    t = tren.prepare_renderer(twav.load(blob), getattr(tcm, layout), 48_000.0,
                              BLOCK, device="cpu", **kw)
    j = jren.prepare_renderer(jwav.load(blob), getattr(jcm, layout), 48_000.0,
                              BLOCK, **kw)
    return t, j


def _assert_same(t, j):
    for a, b in zip(t.conv_params, j.conv_params):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    for field in ("speakers", "sample_rate", "block_size", "generation",
                  "input_channels", "input_indices", "lookahead"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.num_speakers, t.partition_count, t.layout_channels) == \
        (j.num_speakers, j.partition_count, j.layout_channels)


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("bucketing", ["exact", "pow2"])
def test_prepare_renderer_bit_identical(lookahead, bucketing):
    t, j = _both(_wav_bytes(), "STEREO", lookahead=lookahead,
                 partition_bucketing=bucketing)
    _assert_same(t, j)
    assert t.device == torch.device("cpu")


def test_prepare_renderer_resamples_and_forces_partitions():
    """A 44.1 kHz bank resampled to 48 kHz by the default linear resampler,
    a 5.1 layout, and a forced partition count."""
    t, j = _both(_wav_bytes(rate=44_100.0), "SURROUND_5_1", partitions=12)
    _assert_same(t, j)
    assert t.partition_count == 12


def test_atmos_714_skips_heights_and_selects_input():
    """7.1.4 through the height-less hesuvi14 map: the four top channels
    are skipped, and select_input maps a 12-channel chunk onto the 8
    resolved speakers, as the JAX renderer does."""
    t, j = _both(_wav_bytes(seed=7), "ATMOS_7_1_4")
    _assert_same(t, j)
    assert t.num_speakers == 8 and t.layout_channels == 12
    assert tcm.TFL not in t.speakers
    chunk = np.random.default_rng(6).standard_normal((12, 40)).astype(np.float32)
    np.testing.assert_array_equal(t.select_input(chunk), j.select_input(chunk))
    assert t.select_input(chunk[:8]).shape == (8, 40)  # already resolved
    heights = tcm.InputLayout((tcm.TFL, tcm.TFR, tcm.TBL, tcm.TBR), "tops")
    with pytest.raises(tren.RendererPreparationError):
        tren.prepare_renderer(twav.load(_wav_bytes()), heights, 48_000.0,
                              BLOCK, channel_map=tcm.hesuvi_14_channel(
                                  heights.channels), device="cpu")
