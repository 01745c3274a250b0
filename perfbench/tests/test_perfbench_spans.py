"""The program's spans (airwave_tpu_torch/utils/profiling.span) against the
harness as it reads traces: every per-layer reader gives the same number
from a trace with and without the spans in it, an idle gap where the host
sat inside a span outside any op is labelled with the span's name, and no
traced window of an entry on the CPU rebuilds anything (no
`airwave.build.*` span) once warm."""

from pathlib import Path

import pytest

from conftest import CELLS, at_tier
from perfbench.core import trace as tracing
from perfbench.core.cell import Run
from perfbench.core.spec import Spec
from perfbench.core.traffic import make_inputs, run_loop

MAIN, STREAM = 1, 7
PROGRAM = "airwave_tpu_torch"
STEPS = 2
STEP_US = 500.0

# One ring step's host side, offsets in us from the step's start: (kind,
# name, start, end). "frame" is a Python frame of the program, "span" a
# program span, "launch" a kernel launch with the kernel's (name, device
# start, device end).
STEP_EVENTS = [
    ("frame", "models/binaural.py(70): chain_step_fn", 5, 400),
    ("span", "airwave.chain.step", 6, 399),
    ("frame", "ops/upols.py(390): conv_step", 10, 200),
    ("span", "airwave.conv.analysis", 12, 40),
    ("launch", ("sgemm_analysis", 30, 60), 20, 25),
    ("frame", "kernels/mac_kmajor.py(260): mac_kmajor", 50, 100),
    ("span", "airwave.mac.single.balanced", 60, 90),
    ("launch", ("mac_kmajor_tiled_4_4", 80, 140), 70, 75),
    ("span", "airwave.conv.synthesis", 120, 160),
    ("launch", ("sgemm_synthesis", 150, 200), 130, 135),
    ("frame", "ops/eq_block.py(110): eq_step", 250, 350),
    ("span", "airwave.eq.cascade", 252, 348),
    ("launch", ("sgemm_eq", 310, 400), 300, 305),
]


def chrome_trace(spans: bool, stacks: bool) -> list:
    """A Chrome trace of a window of STEPS ring steps as torch.profiler
    writes it, with or without the program's spans and Python frames."""
    def x(cat, name, ts, end, tid=MAIN, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts,
                "dur": end - ts, "pid": 0, "tid": tid, "args": args}

    events = [x("user_annotation", tracing.WINDOW, 0.0, STEPS * STEP_US)]
    corr = 100
    for k in range(STEPS):
        b = 10.0 + k * STEP_US
        events.append(x("user_annotation", tracing.STEP, b, b + 480))
        for kind, name, s, e in STEP_EVENTS:
            if kind == "frame" and stacks:
                events.append(x("python_function", f"{PROGRAM}/{name}",
                                b + s, b + e))
            elif kind == "span" and spans:
                events.append(x("user_annotation", name, b + s, b + e))
            elif kind == "launch":
                corr += 1
                kernel, ks, ke = name
                events.append(x("cuda_runtime", "cudaLaunchKernel", b + s,
                                b + e, correlation=corr))
                events.append(x("kernel", kernel, b + ks, b + ke,
                                tid=STREAM, correlation=corr))
    return events


def run_of(plain, stacked) -> Run:
    config = Spec().config("ring_hesuvi_stereo")
    return Run(config=config, traffic={}, lanes=8192, frames_per_step=512,
               blocks_per_step=1, sample_rate=48_000.0, setup_s=1.0,
               window_steps=10, window_s=1.0, round_ms=[1.0] * 10,
               dispatch_ns=[400_000] * 10, peak_bytes=0, input_bytes=0,
               on_card=True, plain=plain, stacked=stacked)


def readings(spans: bool) -> dict:
    plain = tracing.parse(chrome_trace(spans, stacks=False))
    stacked = tracing.parse(chrome_trace(spans, stacks=True))
    spec = Spec()
    run = run_of(plain, stacked)
    return {m["name"]: spec.metric_reader(m["name"]).read(run)
            for m in spec.data["per_layer"]}


def test_every_reader_reads_the_same_with_spans():
    without, with_spans = readings(False), readings(True)
    assert with_spans == without
    # Not vacuous: each layer of the ring step is read from the trace.
    assert without["dft.device_ms_per_block"] == pytest.approx(0.08)
    assert without["eq.device_ms_per_block"] == pytest.approx(0.09)
    assert without["mac_single.roofline_pct"] > 0
    assert without["device.idle_pct"] > 0
    assert without["mac_pages.roofline_pct"] is None
    # At "highest" no relaxed product runs.
    assert without["dft_relaxed.roofline_pct"] is None


def test_idle_gap_names_the_span_the_host_sat_in():
    # The device idles from the synthesis's end (200) to the EQ's start
    # (310) while the host is inside eq_step, outside any op.
    without = tracing.parse(chrome_trace(False, stacks=False))
    with_spans = tracing.parse(chrome_trace(True, stacks=False))
    assert dict(with_spans.gaps)["airwave.eq.cascade"] == pytest.approx(
        STEPS * 110.0)
    assert not [g for g, _ in without.gaps if g.startswith("airwave.")]
    # The spans move labels, never idle time.
    assert sum(us for _, us in with_spans.gaps) == pytest.approx(
        sum(us for _, us in without.gaps))


def traced_window_spans(root: str, bench: str, cell: str) -> dict:
    """The program's span names in a traced window of `cell` on the CPU
    after its warm-up, and the window's steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = Spec(Path(root), Path(bench))
    w = spec.cell(cell)
    config = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    dev = torch.device("cpu")
    entry = spec.entry(traffic["entry"]).Entry(config, traffic, 3, dev)
    inputs = make_inputs(entry.step_shape, traffic, 3, dev)
    warm = int(traffic["warmup_steps"])
    with torch.inference_mode():
        run_loop(entry.step, inputs, traffic, 0, dev, max_steps=warm)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            window = run_loop(entry.step, inputs, traffic, warm, dev,
                              max_steps=int(traffic["trace_steps"]))
    return {"steps": window.steps,
            "names": [e.name for e in prof.events()
                      if e.name.startswith("airwave.")]}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_window_builds_nothing_once_warm(tiny_spec, cell):
    tier = tiny_spec.config(tiny_spec.cell(cell)["config"])["tier"]
    got = at_tier(tier, f"{__name__}:traced_window_spans",
                  str(tiny_spec.root), str(tiny_spec.bench_dir), cell)
    names = got["names"]
    assert names.count("airwave.chain.step") == got["steps"] > 0
    assert not [n for n in names if n.startswith("airwave.build.")]
