"""The 7.1 configuration's pieces: analysis.device_ms_per_block's attribution
on a synthetic trace of one ring step (the analysis ops count, the MAC's,
the synthesis's and the EQ's do not), and the 7.1 reference broken one
speaker at a time, which the program's output then misses by over 10x the
cell's limit."""

import copy
import types

import pytest

from perfbench.core import trace as tracing
from perfbench.core.cell import Run, run_cell
from perfbench.core.spec import Spec

CELL = "ring.71.eq.b8192"
METRIC = "analysis.device_ms_per_block"
MAIN, STREAM = 1, 7
STEPS = 3
STEP_US = 1000.0

# One 7.1 ring step's host side, offsets in us from the step's start:
# (kind, name, start, end); a launch's name is the kernel's (name, device
# start, device end). Frames are the program's, as torch.profiler names
# them with stacks.
STEP_EVENTS = [
    ("frame", "models/binaural.py(95): chain_step_fn", 5, 900),
    ("frame", "ops/upols.py(371): conv_step", 10, 600),
    ("frame", "ops/fftmm.py(76): rfft_mm", 12, 40),
    ("frame", "ops/precision.py(200): matmul", 14, 38),
    ("launch", ("sgemm_analysis", 30, 230), 20, 25),           # 200 us
    ("frame", "ops/upols.py(330): _to_slot", 42, 60),
    ("launch", ("pad_kernel", 230, 270), 45, 50),               # 40 us
    ("launch", ("copy_slot", 270, 330), 62, 66),                # 60 us
    ("frame", "ops/upols.py(353): _mac_irfft", 70, 590),
    ("frame", "ops/upols.py(337): _mac_columns", 72, 100),
    ("frame", "kernels/mac_kmajor.py(311): mac_kmajor", 74, 98),
    ("launch", ("mac_kmajor_tiled_4_4", 330, 430), 80, 85),
    ("frame", "ops/precision.py(200): matmul", 110, 140),
    ("launch", ("sgemm_synthesis", 430, 530), 120, 125),
    ("frame", "ops/eq_block.py(110): eq_step", 650, 850),
    ("launch", ("sgemm_eq", 530, 600), 700, 705),
]
ANALYSIS_US = 200 + 40 + 60


def chrome_trace(stacks: bool) -> list:
    """A Chrome trace of a window of STEPS such steps, as torch.profiler
    writes it, with or without the Python frames."""
    def x(cat, name, ts, end, tid=MAIN, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts,
                "dur": end - ts, "pid": 0, "tid": tid, "args": args}

    events = [x("user_annotation", tracing.WINDOW, 0.0, STEPS * STEP_US)]
    corr = 100
    for k in range(STEPS):
        b = 10.0 + k * STEP_US
        events.append(x("user_annotation", tracing.STEP, b, b + 950))
        for kind, name, s, e in STEP_EVENTS:
            if kind == "frame" and stacks:
                events.append(x("python_function",
                                f"{tracing.PROGRAM}/{name}", b + s, b + e))
            elif kind == "launch":
                corr += 1
                kernel, ks, ke = name
                events.append(x("cuda_runtime", "cudaLaunchKernel", b + s,
                                b + e, correlation=corr))
                events.append(x("kernel", kernel, b + ks, b + ke,
                                tid=STREAM, correlation=corr))
    return events


def run_of(config_name: str, stacked) -> Run:
    spec = Spec()
    config = spec.config(config_name)
    return Run(config=config, traffic={}, lanes=8192, frames_per_step=512,
               blocks_per_step=int(config["blocks_per_step"]),
               sample_rate=48_000.0, setup_s=1.0, window_steps=10,
               window_s=1.0, round_ms=[1.0] * 10,
               dispatch_ns=[400_000] * 10, peak_bytes=0, input_bytes=0,
               on_card=True, plain=None, stacked=stacked)


def test_analysis_metric_reads_the_analysis_ops_alone():
    reader = Spec().metric_reader(METRIC)
    stacked = tracing.parse(chrome_trace(stacks=True))
    got = reader.read(run_of("ring_hesuvi_71", stacked))
    assert got == pytest.approx(ANALYSIS_US / 1e3)
    owned = {op.name for op in stacked.ops if reader.owned(op)}
    assert owned == {"sgemm_analysis", "pad_kernel", "copy_slot"}
    # The convolution layer's reader sums the synthesis with it.
    dft = Spec().metric_reader("dft.device_ms_per_block").read(
        run_of("ring_hesuvi_71", stacked))
    assert dft == pytest.approx((ANALYSIS_US + 100) / 1e3)
    # Nothing without stacks, nothing on the paged tier.
    plain = tracing.parse(chrome_trace(stacks=False))
    assert reader.read(run_of("ring_hesuvi_71", plain)) is None
    assert reader.read(run_of("bake_hesuvi_stereo", stacked)) is None


def broken_reference(ref, speaker: int, how: str):
    """`ref` with one speaker of the 7.1 layout broken: its response left
    out, or its ears swapped."""
    def responses(bank, layout, eq, sample_rate):
        g = ref.responses(bank, layout, eq, sample_rate).copy()
        if how == "left_out":
            g[speaker] = 0.0
        else:
            g[speaker] = g[speaker, ::-1].copy()
        return g

    return types.SimpleNamespace(responses=responses, render=ref.render)


@pytest.mark.parametrize("how", ["left_out", "ears_swapped"])
def test_reference_broken_one_speaker_at_a_time(tiny_spec, how):
    ref = tiny_spec.reference(tiny_spec.config(
        tiny_spec.cell(CELL)["config"])["reference"])
    assert len(ref.LAYOUTS["7.1"]) == 8
    for speaker in range(8):
        spec = copy.copy(tiny_spec)
        spec.reference = lambda name, s=speaker: broken_reference(ref, s, how)
        result, checks = run_cell(spec, CELL, 2**31 + 33, 0.05, False, "cpu")
        worst = checks[0]
        assert worst.name == "worst_rel_rms"
        assert worst.value > 10 * worst.limit, (speaker, worst.value)
        assert result["correct"] is False
