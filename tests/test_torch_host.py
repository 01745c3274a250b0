"""The port's own copies of the host modules (io.apo, io.wav,
assets.channel_maps, ops.resample, config) give what the JAX package's give
on the same inputs: equal results, and errors of the same name."""

import dataclasses
import io

import numpy as np
import pytest

from airwave_tpu import config as jconfig
from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.io import apo as japo
from airwave_tpu.io import wav as jwav
from airwave_tpu.ops import resample as jresample
from airwave_tpu_torch import config as tconfig
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.io import wav as twav
from airwave_tpu_torch.ops import resample as tresample

PRESETS = [
    b"Preamp: -2.56 dB\nFilter 1: ON PK Fc 894.2 Hz Gain 2.0 dB Q 1.24\n",
    b"\xef\xbb\xbf# comment\n\nPreamp: -6 dB\n"
    b"Filter 1: ON LSC Fc 105 Hz Gain -2.8 dB Q 0.70\n"
    b"Filter 2: OFF PK Fc 2000 Hz Gain 3.0 dB Q 1.0\n"
    b"Filter 3: ON HSC Fc 10000 Hz Gain -5.2 dB Q 0.70\n",
    b"Filter 1: ON PK Fc 1000 Hz Gain 1 dB Q 2\n",
    # Faults: duplicate preamp, malformed line, non-finite number, nothing.
    b"Preamp: -1 dB\nPreamp: -2 dB\n",
    b"Preamp: -1 dB\nFilter 1: ON XX Fc 1000 Hz Gain 1 dB Q 1\n",
    b"Filter 1: ON PK Fc nan Hz Gain 1 dB Q 1\n",
    b"# nothing here\n",
    b"\xff\xfe not utf-8",
]


def _as_plain(definition):
    return (definition.preamp_db,
            [(f.source_line, f.source_number, f.is_enabled, f.type.name,
              f.frequency_hz, f.gain_db, f.q) for f in definition.filters])


@pytest.mark.parametrize("data", PRESETS)
def test_apo_parse_matches(data):
    try:
        ref = japo.parse(data, "preset.txt")
    except Exception as err:  # the JAX parser's verdict decides the case
        with pytest.raises(Exception) as got:
            tapo.parse(data, "preset.txt")
        assert type(got.value).__name__ == type(err).__name__
        assert str(got.value) == str(err)
        return
    assert _as_plain(tapo.parse(data, "preset.txt")) == _as_plain(ref)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_wav_save_and_load_match(dtype):
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((14, 333)) * 0.3).astype(np.float32)
    blobs = []
    for mod in (twav, jwav):
        buf = io.BytesIO()
        mod.save(buf, audio, 44_100.0, dtype=dtype)
        blobs.append(buf.getvalue())
    assert blobs[0] == blobs[1]
    t, j = twav.load(blobs[0]), jwav.load(blobs[0])
    assert t.sample_rate == j.sample_rate == 44_100.0
    assert t.channel_count == j.channel_count == 14
    np.testing.assert_array_equal(t.audio, j.audio)
    if dtype == "float32":
        np.testing.assert_array_equal(t.audio, audio)
    with pytest.raises(Exception) as err_t:
        twav.load(blobs[0][:30])
    with pytest.raises(Exception) as err_j:
        jwav.load(blobs[0][:30])
    assert type(err_t.value).__name__ == type(err_j.value).__name__


@pytest.mark.parametrize("layout", ["STEREO", "SURROUND_5_1", "SURROUND_7_1",
                                    "ATMOS_7_1_4"])
@pytest.mark.parametrize("hrir_channels", [7, 14])
def test_select_channel_map_indices_match(layout, hrir_channels):
    tl, jl = getattr(tcm, layout), getattr(jcm, layout)
    assert tl.channels == jl.channels
    tmap = tcm.select_channel_map(hrir_channels, tl.channels)
    jmap = jcm.select_channel_map(hrir_channels, jl.channels)
    for speaker in tl.channels:
        assert tmap.indices(speaker) == jmap.indices(speaker), speaker
    assert tcm.detect_layout(len(tl.channels)).channels == \
        jcm.detect_layout(len(jl.channels)).channels


@pytest.mark.parametrize("rates", [(44_100.0, 48_000.0), (48_000.0, 44_100.0),
                                   (96_000.0, 48_000.0), (48_000.0, 48_000.005)])
def test_resample_linear_matches(rates):
    x = np.random.default_rng(2).standard_normal((2, 4320)).astype(np.float32)
    got = tresample.resample_linear(x, *rates)
    ref = jresample.resample_linear(x, *rates)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_config_matches():
    assert (dataclasses.asdict(tconfig.DEFAULT_CONFIG)
            == dataclasses.asdict(jconfig.DEFAULT_CONFIG))
    for rate in (44_100.0, 48_000.0, 96_000.0):
        assert (tconfig.DEFAULT_CONFIG.transition_length(rate)
                == jconfig.DEFAULT_CONFIG.transition_length(rate))
    assert tconfig.DEFAULT_CONFIG.eq_state_dim == jconfig.DEFAULT_CONFIG.eq_state_dim
