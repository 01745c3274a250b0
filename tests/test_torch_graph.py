"""graph/frame_adapter, spatial_effect, effect_graph, eq_processor,
oracle/eq_oracle and utils/profiling of the PyTorch port against the JAX
package's, on the CPU (mirrors tests/test_graph.py).

The port's device effects run with device="cpu" (the kernels' plain
versions); the JAX package under JAX_PLATFORMS=cpu. Rendered audio is held
within 1e-5 rel-RMS of the float64 oracles and of the JAX effects on the
same seeded input.
"""

import numpy as np
import pytest

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph import effect_graph as jeg
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.graph.spatial_effect import SpatialEffect as JSpatial
from airwave_tpu.io import apo as japo
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.oracle.eq_oracle import EqCascadeOracle as JOracle
from airwave_tpu.oracle.upols_oracle import UPOLSOracle
from airwave_tpu.ops import biquad_design as jbd
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph import effect_graph as teg
from airwave_tpu_torch.graph.effect_graph import (EQUALIZER, SPATIAL,
                                                  AudioEffectGraph,
                                                  DeviceEqualizerEffect,
                                                  EqualizerEffect)
from airwave_tpu_torch.graph.frame_adapter import FrameAdapter
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.graph.spatial_effect import SpatialEffect
from airwave_tpu_torch.io import apo as tapo
from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                      FilterType)
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.ops import biquad_design as tbd
from airwave_tpu_torch.oracle.eq_oracle import EqCascadeOracle
from airwave_tpu_torch.utils.profiling import RenderProfiler, device_trace

SR = 48_000.0
TOL = 1e-5


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)),
                                                  1e-30)


def identity_render(block):
    return block[:, :2, :]


def make_identity_renderer(block_size=512):
    audio = np.zeros((14, 8), np.float32)
    audio[0, 0] = 1.0   # FL -> left ear
    audio[7, 0] = 1.0   # FR -> right ear
    return tprepare(TWAVData(SR, audio), tcm.STEREO, SR, block_size,
                    device="cpu")


def oracle_render(audio, x, layout, block):
    """float64 UPOLS render of x [S, n] (n a multiple of block) through the
    bank's hesuvi14 pairs for `layout`."""
    n = x.shape[1]
    m = tcm.hesuvi_14_channel(layout.channels)
    ref = np.zeros((2, n))
    for spk, speaker in enumerate(layout.channels):
        for ear, ch in zip((0, 1), m.indices(speaker)):
            o = UPOLSOracle(audio[ch], block)
            ref[ear] += np.concatenate(
                [o.process(x[spk, i * block:(i + 1) * block])
                 for i in range(n // block)])
    return ref


def test_adapter_latency_contract_384_zeros_at_128():
    adapter = FrameAdapter(identity_render, batch=1, in_channels=2,
                           block_size=512, max_frames_per_callback=4096)
    x = np.arange(1, 2049, dtype=np.float32)[None, None, :].repeat(2, 1)
    y = np.concatenate([adapter.process(x[:, :, i:i + 128])
                        for i in range(0, 2048, 128)], axis=-1)[0, 0]
    assert np.all(y[:384] == 0)
    np.testing.assert_array_equal(y[384:], x[0, 0, :2048 - 384])


def test_adapter_mixed_sizes_and_reset():
    adapter = FrameAdapter(identity_render, batch=2, in_channels=2,
                           block_size=512, max_frames_per_callback=4096)
    rng = np.random.default_rng(0)
    sizes = [1, 7, 128, 512, 1024, 333, 4096, 64, 2048]
    x = rng.standard_normal((2, 2, sum(sizes))).astype(np.float32)
    outs, off = [], 0
    for s in sizes:
        outs.append(adapter.process(x[:, :, off:off + s]))
        off += s
    y = np.concatenate(outs, axis=-1)
    assert y.shape == x.shape and np.all(np.isfinite(y))
    nonzero = y[0, 0][y[0, 0] != 0]
    np.testing.assert_array_equal(nonzero, x[0, 0, :len(nonzero)])
    assert len(nonzero) >= sum(sizes) - 512 - 333
    adapter.reset()
    np.testing.assert_array_equal(
        adapter.process(np.zeros((2, 2, 512), np.float32)), 0)


def test_spatial_effect_identity_roundtrip_and_mono_dup():
    effect = SpatialEffect(batch=1, sample_rate=SR, device="cpu")
    assert not effect.is_ready
    effect.set_renderer(make_identity_renderer())
    assert effect.is_ready
    x = np.random.default_rng(1).standard_normal((1, 2, 512)).astype(np.float32)
    np.testing.assert_allclose(effect.process(x), x, atol=1e-4)
    effect.reset()
    y = effect.process(np.ones((1, 1, 512), np.float32))
    np.testing.assert_allclose(y, 1.0, atol=1e-4)


def test_spatial_effect_matches_oracle_and_jax():
    """SpatialEffect (port) against the float64 oracle and the JAX
    SpatialEffect on the same bank and input, in callbacks of mixed size
    (tests/test_graph.py:114)."""
    rng = np.random.default_rng(5)
    block = 64
    audio = (rng.standard_normal((14, 300)) * 0.2).astype(np.float32)
    effects = []
    for cls, prep, wav, kw in ((SpatialEffect, tprepare, TWAVData,
                                {"device": "cpu"}),
                               (JSpatial, jprepare, JWAVData, {})):
        eff = cls(batch=2, sample_rate=SR, block_size=block, **kw)
        eff.set_renderer(prep(wav(SR, audio),
                              (tcm if cls is SpatialEffect else jcm).STEREO,
                              SR, block, **kw))
        effects.append(eff)
    n = 8 * block
    x = rng.standard_normal((2, 2, n)).astype(np.float32)
    sizes = [64, 100, 28, 192, 128]
    outs = [[], []]
    off = 0
    for s in sizes:
        for eff, out in zip(effects, outs):
            out.append(eff.process(x[:, :, off:off + s]))
        off += s
    port, jax_out = (np.concatenate(o, axis=-1) for o in outs)
    assert rel_rms(port, jax_out) < TOL
    # One block-aligned callback drains with zero adapter lag: the oracle's
    # output, sample for sample.
    effects[0].reset()
    y = effects[0].process(x)
    for b in range(2):
        assert rel_rms(y[b], oracle_render(audio, x[b], tcm.STEREO,
                                           block)) < TOL


def test_crossfaded_renderer_swap_keeps_adapter_samples():
    """A crossfaded set_renderer keeps the adapter's buffered samples (the
    stream stays continuous); a resetting swap drops them."""
    block = 64
    rng = np.random.default_rng(8)
    banks = [(rng.standard_normal((14, 300)) * 0.2).astype(np.float32)
             for _ in range(2)]
    renderers = [tprepare(TWAVData(SR, a), tcm.STEREO, SR, block,
                          device="cpu") for a in banks]
    eff = SpatialEffect(batch=1, sample_rate=SR, block_size=block,
                        device="cpu")
    eff.set_renderer(renderers[0])
    eff.process(np.ones((1, 2, 100), np.float32))
    pending = eff.adapter.pending_count
    assert pending == 100 - block
    eff.set_renderer(renderers[1])
    assert eff.adapter.pending_count == pending
    eff.set_renderer(renderers[0], crossfade=False)
    assert eff.adapter.pending_count == 0


class FakeSpatial:
    def __init__(self, ready=True, gain=2.0):
        self.is_ready = ready
        self.gain = gain

    def process(self, x):
        return x[:, :2, :] * self.gain


def test_graph_orders_spatial_then_eq_and_passthrough():
    graph = AudioEffectGraph(FakeSpatial(gain=2.0))
    result = graph.prepare(SR, EqualizerDefinition(preamp_db=6.0))
    assert result.runnable_effects == {SPATIAL, EQUALIZER}
    x = np.ones((1, 2, 960), np.float32)
    graph.process(x)
    np.testing.assert_allclose(graph.process(x), 2.0 * 10 ** (6 / 20),
                               rtol=1e-5)

    graph = AudioEffectGraph(FakeSpatial(ready=False))
    assert graph.prepare(SR, None).no_effect_can_run
    x = np.random.default_rng(0).standard_normal((1, 2, 64)).astype(np.float32)
    np.testing.assert_array_equal(graph.process(x), x)
    y = graph.process(np.ones((1, 1, 64), np.float32))
    np.testing.assert_array_equal(y[:, 0], y[:, 1])


@pytest.mark.parametrize("batch", [1, 2])
def test_graph_eq_failures_are_nonfatal_line_numbered(batch):
    """Design failures warn with the filter's line and spatial continues;
    an invalid live target keeps the EQ for the unity ramp; an update on a
    never-prepared graph warns without arming the EQ (tests/test_graph.py:
    180-239), with the host EQ (batch 1) and the device EQ (batch 2)."""
    graph = AudioEffectGraph(FakeSpatial(ready=True), batch=batch,
                             device="cpu")
    bad = EqualizerDefinition(filters=(
        EqualizerFilter(7, None, True, FilterType.PEAKING, 24_000, 1, 1),))
    result = graph.prepare(SR, bad)
    assert result.runnable_effects == {SPATIAL}
    assert result.equalizer_warning.filter_line == 7
    assert "Equalizer line 7" in str(result.equalizer_warning)
    np.testing.assert_allclose(graph.process(np.ones((batch, 2, 8),
                                                     np.float32)), 2.0)

    graph = AudioEffectGraph(FakeSpatial(ready=False), batch=batch,
                             device="cpu")
    result = graph.update_equalizer(EqualizerDefinition(preamp_db=3.0))
    assert result.equalizer_warning is not None
    assert not graph.equalizer_active
    x = np.ones((batch, 2, 64), np.float32)
    np.testing.assert_array_equal(graph.process(x), x)

    graph.prepare(SR, EqualizerDefinition(preamp_db=6.0))
    graph.process(np.ones((batch, 2, 960), np.float32))  # settle the ramp
    bad3 = EqualizerDefinition(filters=(
        EqualizerFilter(3, None, True, FilterType.PEAKING, 30_000, 1, 1),))
    result = graph.update_equalizer(bad3)
    assert result.equalizer_warning.filter_line == 3
    assert graph.equalizer_active
    y = graph.process(np.ones((batch, 2, 960), np.float32))
    assert abs(y[0, 0, -1] - 1.0) < 1e-5


def test_graph_update_to_none_keeps_unity_ramp():
    graph = AudioEffectGraph(FakeSpatial(ready=False))
    graph.prepare(SR, EqualizerDefinition(preamp_db=6.0))
    graph.process(np.ones((1, 2, 960), np.float32))
    assert graph.update_equalizer(None).equalizer_warning is None
    assert graph.equalizer_active
    y = graph.process(np.ones((1, 2, 960), np.float32))
    gain = 10 ** (6 / 20)
    assert abs(y[0, 0, 0] - (gain - (gain - 1) / 960)) < 1e-4
    assert abs(y[0, 0, -1] - 1.0) < 1e-5


def _definitions(apo):
    first = apo.EqualizerDefinition(preamp_db=-2.0, filters=(
        apo.EqualizerFilter(1, None, True, apo.FilterType.PEAKING,
                            1000.0, 4.0, 1.1),))
    second = apo.EqualizerDefinition(preamp_db=1.0, filters=(
        apo.EqualizerFilter(1, None, True, apo.FilterType.HIGH_SHELF,
                            4000.0, -3.0, 0.8),))
    return first, second


def test_device_equalizer_matches_host_rows_and_jax():
    """DeviceEqualizerEffect (one eq_step per callback) against B host
    float64 processors and against the JAX device EQ, through a retarget
    ramp and mixed callback sizes (tests/test_graph.py:256)."""
    rng = np.random.default_rng(5)
    B = 3
    host = EqualizerEffect(batch=B)
    device = DeviceEqualizerEffect(batch=B, device="cpu")
    jdevice = jeg.DeviceEqualizerEffect(batch=B)
    t_defs, j_defs = _definitions(tapo), _definitions(japo)
    for eff, defs in ((host, t_defs), (device, t_defs), (jdevice, j_defs)):
        eff.prepare(defs[0], SR)
    sizes = (512, 512, 128, 512, 37, 512, 491)
    for i, n in enumerate(sizes):
        if i == 3:
            for eff, defs in ((host, t_defs), (device, t_defs),
                              (jdevice, j_defs)):
                eff.set_target(defs[1])
        x = (rng.standard_normal((B, 2, n)) * 0.4).astype(np.float32)
        got = device.process_batch(x)
        want = np.empty_like(x)
        for b in range(B):
            want[b, 0], want[b, 1] = host.process(x[b, 0], x[b, 1], stream=b)
        assert rel_rms(got, want) < TOL, (i, n)
        assert rel_rms(got, jdevice.process_batch(x)) < TOL, (i, n)


def test_graph_batched_runs_one_device_step_per_callback(monkeypatch):
    graph = AudioEffectGraph(FakeSpatial(ready=False), batch=16, device="cpu")
    assert isinstance(graph.equalizer, teg.DeviceEqualizerEffect)
    graph.prepare(SR, EqualizerDefinition(preamp_db=6.0))
    calls = {"steps": 0}
    real = teg.eq_block.eq_step

    def counting(*args, **kwargs):
        calls["steps"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(teg.eq_block, "eq_step", counting)
    x = np.ones((16, 2, 512), np.float32)
    graph.process(x)
    graph.process(x)
    assert calls["steps"] == 2


def test_surround71_downmix_matches_oracle():
    """BASELINE config 3: 7.1 input through the 14-channel map (LFE shares
    the FC pair) and the stereo downmix, against float64
    (tests/test_graph.py:289)."""
    rng = np.random.default_rng(11)
    block = 128
    audio = (rng.standard_normal((14, 300)) * 0.2).astype(np.float32)
    renderer = tprepare(TWAVData(SR, audio), tcm.SURROUND_7_1, SR, block,
                        device="cpu")
    assert renderer.num_speakers == 8
    effect = SpatialEffect(batch=1, sample_rate=SR, block_size=block,
                           device="cpu")
    effect.set_renderer(renderer)
    x = (rng.standard_normal((1, 8, 6 * block)) * 0.25).astype(np.float32)
    y = effect.process(x)
    ref = oracle_render(audio, x[0], tcm.SURROUND_7_1, block)
    assert rel_rms(y[0], ref) < TOL
    m = tcm.hesuvi_14_channel(tcm.SURROUND_7_1.channels)
    assert m.indices(tcm.FC) == m.indices(tcm.LFE) == (6, 13)


def test_host_eq_oracle_matches_jax_copy():
    """The port's copy of the float64 EQ oracle equals the JAX package's
    bit for bit, exact and sosfilt paths."""
    preamp, coeffs = tbd.design_cascade(_definitions(tapo)[0], SR)
    jpreamp, jcoeffs = jbd.design_cascade(_definitions(japo)[0], SR)
    x = np.random.default_rng(2).standard_normal(300).astype(np.float32)
    a, b = EqCascadeOracle(coeffs, preamp, SR), JOracle(jcoeffs, jpreamp, SR)
    for _ in range(2):
        for fa, fb in ((a.process, b.process),
                       (a.process_exact, b.process_exact)):
            for u, v in zip(fa(x[:100], x[100:200]), fb(x[:100], x[100:200])):
                np.testing.assert_array_equal(u, v)


def test_render_profiler_and_device_trace(tmp_path):
    prof = RenderProfiler(SR, 512, batch=2)
    for _ in range(3):
        with prof.step():
            pass
    report = prof.report()["render"]
    assert report["steps"] == 3 and report["min_ms"] <= report["max_ms"]
    with device_trace(None):
        pass
    import torch

    with device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert any((tmp_path / "trace").iterdir())
