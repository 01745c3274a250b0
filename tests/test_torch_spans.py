"""The port's spans (utils/profiling.span) on the CPU: where a CPU
torch.profiler records, a chain step is one `airwave.chain.step` range whose
children are the layers in the step's order; with no profiler a span is
one shared null context and no `record_function` is entered; the build
spans mark work done once, on a cache miss alone."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from airwave_tpu_torch.assets import channel_maps
from airwave_tpu_torch.graph.renderer import prepare_renderer
from airwave_tpu_torch.io.wav import WAVData
from airwave_tpu_torch.kernels import mac_kmajor
from airwave_tpu_torch.models.binaural import BinauralEngine
from airwave_tpu_torch.ops import precision
from airwave_tpu_torch.tools.profile_chain import headline_chain
from airwave_tpu_torch.tools.soak import bench_eq_definition
from airwave_tpu_torch.utils import profiling

SR = 48_000.0
BLOCK = 512
LANES = 4


def _spans(fn) -> list:
    """[(name, start us, end us)] of the airwave.* ranges `fn()` opened
    under a CPU profiler, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("airwave.")),
                  key=lambda s: s[1])


def _chain_call(M: int):
    chain, state, x = headline_chain(0, "cpu", LANES, M, 0.01)
    carry = [state]

    @torch.inference_mode()
    def call():
        carry[0], y = chain(carry[0], x)
        return y

    return call


def _engine_call():
    rng = np.random.default_rng(3)
    bank = (rng.standard_normal((14, 480)) * 0.05).astype(np.float32)
    bank[:, 0] += 0.8
    renderer = prepare_renderer(WAVData(SR, bank),
                                channel_maps.detect_layout(2), SR, BLOCK,
                                device="cpu")
    engine = BinauralEngine(LANES, SR, BLOCK, renderer=renderer, device="cpu")
    engine.set_equalizer(bench_eq_definition())
    x = rng.standard_normal((LANES, 2, BLOCK)).astype(np.float32)
    return lambda: engine.process_block(x)


# (the step, the layer spans under airwave.chain.step in order)
STEPS = {
    "chain_m1": (lambda: _chain_call(1),
                 ["airwave.conv.analysis", "airwave.mac.single.ref",
                  "airwave.conv.synthesis", "airwave.eq.cascade"]),
    "chain_m8": (lambda: _chain_call(8),
                 ["airwave.conv.analysis", "airwave.mac.pages.ref",
                  "airwave.conv.synthesis", "airwave.eq.recurrence"]),
    "engine": (_engine_call,
               ["airwave.conv.analysis", "airwave.mac.single.ref",
                "airwave.conv.synthesis", "airwave.eq.cascade"]),
}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_chain_step_span_holds_its_layers_in_order(step):
    make, layers = STEPS[step]
    call = make()
    call()  # warm: nothing is built in the recorded step
    spans = _spans(call)
    assert [s[0] for s in spans] == [profiling.CHAIN_STEP] + layers, spans
    _, start, end = spans[0]
    prev_end = start
    for name, s, e in spans[1:]:
        # Each layer lies inside the step and after the one before it.
        assert prev_end <= s <= e <= end, (name, spans)
        prev_end = e


@pytest.mark.parametrize("M", [1, 8])
def test_no_profiler_no_record_function(monkeypatch, M):
    call = _chain_call(M)
    call()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span(profiling.CHAIN_STEP) is profiling._OFF
    assert isinstance(profiling._OFF, contextlib.nullcontext)
    y = call()
    assert torch.isfinite(y).all()


def _mac_plan_call():
    # A shape no other case plans, with the route given: the plan needs no
    # card (only a route by name asks the card for its SM count).
    route = mac_kmajor.MacRoute("tiled", mac_kmajor.THREADS,
                                mac_kmajor.THREADS)
    rows = (4 * 9, 9, 9, 9)
    return lambda: mac_kmajor._plan(7, 9, 4099, 4, rows, route, 0, True, True)


def _weight_split_call():
    weight = torch.randn(24, 40)
    return lambda: precision.operand(weight.T, "b", "high", key=weight)


@pytest.mark.parametrize("make,name", [
    (_mac_plan_call, profiling.BUILD_MAC_PLAN),
    (_weight_split_call, profiling.BUILD_WEIGHT_OPERAND),
], ids=["mac_plan", "weight_operand"])
def test_build_span_only_on_a_cache_miss(make, name):
    call = make()
    first = _spans(call)
    second = _spans(call)
    assert [s[0] for s in first] == [name]
    assert second == []
