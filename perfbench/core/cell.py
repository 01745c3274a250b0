"""One run of one cell: set-up, the measured window, the traced windows,
the comparison with the plain reference, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import math
import time

from perfbench.core import trace as tracing
from perfbench.core.spec import Spec
from perfbench.core.traffic import make_inputs, run_loop, sample_plan

TOP = 10


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    config: dict
    traffic: dict
    lanes: int
    frames_per_step: int
    blocks_per_step: int
    sample_rate: float
    setup_s: float
    window_steps: int
    window_s: float
    round_ms: list
    dispatch_ns: list
    peak_bytes: int
    input_bytes: int
    on_card: bool
    plain: "tracing.Trace | None" = None     # traced without Python stacks
    stacked: "tracing.Trace | None" = None   # traced with Python stacks


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return f"check {self.name} {self.value!r} limit {self.limit!r}"


def _rel_rms_worst(entry, ref, inputs, captured, lanes, reference_inputs,
                   device) -> tuple:
    """Each captured step's output blocks of the sampled lanes against the
    reference, which renders them from the input history the cycled buffer
    gives (zeros before the stream began). Returns (the worst rel-RMS,
    {step: [rel-RMS of each lane's block]})."""
    import torch

    g = ref.responses(reference_inputs["bank"], reference_inputs["layout"],
                      reference_inputs["eq"], reference_inputs["sample_rate"])
    g = torch.from_numpy(g).to(device)
    F = entry.frames_per_step
    history = g.shape[-1] - 1
    back = -(-history // F)
    n = inputs.shape[0]
    lane_idx = torch.as_tensor(lanes, device=inputs.device)
    worst, per_step = 0.0, {}
    for k, y in sorted(captured.items()):
        parts = []
        for j in range(k - back, k + 1):
            if j < 0:
                parts.append(torch.zeros(
                    (len(lanes), inputs.shape[2], F), dtype=torch.float64,
                    device=device))
            else:
                parts.append(entry.lane_inputs(
                    inputs[j % n].index_select(0, lane_idx)).to(device,
                                                                torch.float64))
        seg = torch.cat(parts, dim=-1)[..., -(history + F):]
        r = ref.render(g, seg, F)
        got = entry.lane_outputs(y).to(device, torch.float64)
        err = ((got - r).pow(2).sum((1, 2)) / r.pow(2).sum((1, 2))).sqrt()
        per_step[k] = err.tolist()
        worst = max(worst, float(err.max()))
    return worst, per_step


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda:0", started: "float | None" = None,
             fault=None, log=None) -> tuple:
    """Run `cell_name` once. Returns (result, checks): the result line's
    object without its "checks" key, and the compared numbers.

    `started` is the process's start on the time.time() clock (set-up is
    counted from it); `fault(step, entry)` may return a broken step for the
    tests of the comparison; `log(line)` takes progress lines."""
    import torch

    started = time.time() if started is None else started
    log = log or (lambda line: None)
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    t_imports = time.time()
    entry = spec.entry(traffic["entry"]).Entry(config, traffic, seed, dev)
    t_built = time.time()
    inputs = make_inputs(entry.step_shape, traffic, seed, dev)
    step = entry.step if fault is None else fault(entry.step, entry)
    warm = int(traffic["warmup_steps"])
    lanes, want = sample_plan(seed, traffic, warm)
    lane_idx = torch.as_tensor(lanes, device=dev)
    want = set(want)
    captured = {}

    def capture(k, y):
        if k in want:
            captured[k] = y.index_select(0, lane_idx)

    def warm_capture(k, y):
        y.index_select(0, lane_idx)

    with torch.inference_mode():
        w = run_loop(step, inputs, traffic, 0, dev, max_steps=warm,
                     after=warm_capture)
        setup_s = time.time() - started
        log(f"setup {setup_s:.3f} s: to the harness {t_imports - started:.3f}, "
            f"program built {t_built - t_imports:.3f}, input and "
            f"{warm} warm-up steps {started + setup_s - t_built:.3f}")
        # The collector stays off in the window: a full collection would
        # stall one round's dispatch at a time of its own choosing.
        gc.collect()
        gc.disable()
        try:
            window = run_loop(step, inputs, traffic, w.first_step + w.steps,
                              dev, seconds=seconds, after=capture)
        finally:
            gc.enable()
        captured[window.first_step + window.steps - 1] = (
            window.last.index_select(0, lane_idx))
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        run = Run(config=config, traffic=traffic, lanes=int(traffic["lanes"]),
                  frames_per_step=entry.frames_per_step,
                  blocks_per_step=int(config["blocks_per_step"]),
                  sample_rate=float(config["sample_rate"]), setup_s=setup_s,
                  window_steps=window.steps, window_s=window.seconds,
                  round_ms=window.round_ms, dispatch_ns=window.dispatch_ns,
                  peak_bytes=int(peak),
                  input_bytes=inputs.numel() * inputs.element_size(),
                  on_card=on_card)
        log(f"window {window.steps} steps in {window.seconds:.3f} s")
        k = window.first_step + window.steps
        if trace:
            traced = int(traffic["trace_steps"])
            for with_stack in (False, True):
                def traced_window(annotate, first=k):
                    run_loop(step, inputs, traffic, first, dev,
                             max_steps=traced, annotate=annotate)

                t = tracing.record(traced_window, dev, with_stack)
                k += traced
                if with_stack:
                    run.stacked = t
                else:
                    run.plain = t
                framed = sum(1 for op in t.ops if op.frames)
                log(f"trace (stacks {with_stack}, recorded {t.stacks}): "
                    f"{t.steps} steps, {len(t.ops)} device records "
                    f"({framed} with program frames), {t.launches} launches, "
                    f"{t.lost} lost, window {t.window_us / 1e3:.3f} ms")
    nonfinite = sum(1 for c in window.checksums if not math.isfinite(c))
    reference_inputs = entry.reference_inputs(config)
    entry.free()
    del step
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    ref = spec.reference(config["reference"])
    t_ref = time.time()
    worst, per_step = _rel_rms_worst(entry, ref, inputs, captured, lanes,
                                     reference_inputs, dev)
    limit = float(traffic["check"]["limit_rel_rms"])
    log(f"reference: {sum(len(v) for v in per_step.values())} blocks "
        f"({len(lanes)} lanes x steps {sorted(per_step)}) in "
        f"{time.time() - t_ref:.3f} s")
    checks = [Check("worst_rel_rms", worst, limit),
              Check("nonfinite_checksums", nonfinite, 0)]
    failed_steps = {k for k, errs in per_step.items()
                    if not all(e <= limit for e in errs)}

    kind = "end_to_end" if not trace else "per_layer"
    metrics = {}
    for m in spec.cell_metrics(cell_name, kind):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c.ok() for c in checks),
        "attempted": window.steps,
        "failed": len(failed_steps) + nonfinite,
        "metrics": metrics,
        "device": device_fields(dev, run),
    }
    if trace and run.plain is not None:
        result["breakdown"] = breakdown(run.plain)
    return result, checks


def device_fields(dev, run: Run) -> dict:
    import torch

    fields = {"platform": "gpu" if run.on_card else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if run.on_card
                       else "cpu"),
              "count": 1, "memory_peak_bytes": run.peak_bytes}
    if run.plain is not None:
        fields["busy_s"] = run.plain.busy_us / 1e6
        fields["window_s"] = run.plain.window_us / 1e6
    return fields


def breakdown(t: tracing.Trace) -> dict:
    """The device ops that took most time, and the longest idle stretches by
    what the host was doing, in seconds, from a trace without stacks."""
    by_name = {}
    for op in t.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.dur_us / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in t.gaps[:TOP]]}
