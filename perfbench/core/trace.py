"""Device traces of a run: torch.profiler windows, read from their Chrome
trace.

A traced window opens with `LEAD_KERNELS` tiny spin kernels and a
synchronize, since a trace on the card loses the first kernel records of its
session; the steps then run inside a `perfbench.window` annotation, each
inside a `perfbench.step` annotation. Every device record (kernel, memcpy,
memset) is tied to its launch on the host through the CUPTI correlation id,
and from there to the step that launched it and, where the window was
recorded with Python stacks, to the frames of the program that were open
around the launch. Nothing here knows a layer: the metric readers map frames
and kernel names to their own layer.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import NamedTuple

WINDOW = "perfbench.window"
STEP = "perfbench.step"
LEAD_KERNELS = 8
PROGRAM = "airwave_tpu_torch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCH_NAME = re.compile(r"Launch|Memcpy|Memset")
_FRAME = re.compile(r"(?:^|/)" + PROGRAM + r"/(.+?)\.py\(\d+\): (\S+)")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    dur_us: float
    step: "int | None"      # index of the traced step that launched it
    frames: tuple           # ((module, function), ...) innermost first


class Trace(NamedTuple):
    window_us: float        # the traced window's length
    busy_us: float          # device time in the window, overlaps merged
    ops: list               # DeviceOp launched inside the window
    steps: int              # steps the window ran
    launches: int           # launches recorded on the host in the window
    lost: int               # launches with no device record
    gaps: list              # [(what the host was doing, idle us)], longest first
    stacks: bool            # whether Python frames were recorded


def lead_kernels(device) -> None:
    """Open a trace's window on the card: spin kernels and a synchronize,
    so that the records the trace loses at its start are theirs."""
    import torch

    with torch.cuda.device(device):
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def record(run_window, device, with_stack: bool) -> Trace:
    """Trace `run_window(annotate)`, which runs and synchronizes the
    window's steps, each inside annotate(); return it parsed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=with_stack) as prof:
        if on_card:
            lead_kernels(device)
        with record_function(WINDOW):
            run_window(lambda: record_function(STEP))
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)


def _enclosing(intervals: list, queries: list) -> dict:
    """For properly nested intervals (start, end, payload) of one thread and
    queries (time, key): {key: [payload, ...] outermost first} of the
    intervals open at each query's time."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [p for s, e, p in stack if e >= t]
    return out


def _merge(intervals: list, lo: float, hi: float) -> list:
    """Union of (start, end) intervals clipped to [lo, hi], sorted."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def parse(events: list) -> Trace:
    """Read a Chrome trace of one window (see the module's docstring)."""
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} {WINDOW} annotations in the trace")
    win = windows[0]
    w0, w1, main = win["ts"], win["ts"] + win["dur"], win.get("tid")

    host = {}
    steps, launches = [], {}
    for e in events:
        cat = e.get("cat")
        if cat not in HOST_CATS or e.get("ph") != "X":
            continue
        ts, end = e["ts"], e["ts"] + e.get("dur", 0)
        host.setdefault(e.get("tid"), []).append((ts, end, e))
        if cat == "user_annotation" and e.get("name") == STEP and w0 <= ts <= w1:
            steps.append((ts, end))
        corr = (e.get("args") or {}).get("correlation")
        if (cat in LAUNCH_CATS and corr is not None and w0 <= ts <= w1
                and _LAUNCH_NAME.search(e.get("name", ""))):
            launches[corr] = e
    steps.sort()

    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e.get("ph") == "X"]
    recorded = {(e.get("args") or {}).get("correlation") for e in device}
    lost = sum(1 for c in launches if c not in recorded)

    stacks = any(e.get("cat") == "python_function" for _, _, e in
                 host.get(main, []))
    queries = {}
    for i, e in enumerate(device):
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            queries.setdefault(launch.get("tid"), []).append((launch["ts"], i))
    open_at = {}
    for tid, qs in queries.items():
        open_at.update(_enclosing(host.get(tid, []), qs))

    step_starts = [s for s, _ in steps]
    ops = []
    for i, e in enumerate(device):
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            # Without its launch record an op counts when it ran in the
            # window; its step and frames are unknown.
            if not w0 <= e["ts"] <= w1:
                continue
            ops.append(DeviceOp(e["name"], e["ts"], e.get("dur", 0.0), None, ()))
            continue
        frames = []
        for h in reversed(open_at.get(i, [])):
            if h.get("cat") == "python_function":
                m = _FRAME.search(h.get("name", ""))
                if m:
                    frames.append((m.group(1), m.group(2)))
        t = launch["ts"]
        j = bisect.bisect_right(step_starts, t) - 1
        step = j if j >= 0 and t <= steps[j][1] else None
        ops.append(DeviceOp(e["name"], e["ts"], e.get("dur", 0.0), step,
                            tuple(frames)))

    busy = _merge([(o.start_us, o.start_us + o.dur_us) for o in ops], w0, w1)
    busy_us = sum(e - s for s, e in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
             if edges[k + 1] > edges[k]]
    labels = _enclosing(host.get(main, []),
                        [((s + e) / 2, k) for k, (s, e) in enumerate(holes)])
    idle = {}
    for k, (s, e) in enumerate(holes):
        inner = [h for h in labels.get(k, [])
                 if h.get("cat") != "python_function"
                 and h.get("name") not in (WINDOW, STEP)]
        label = inner[-1]["name"] if inner else "host between calls"
        idle[label] = idle.get(label, 0.0) + (e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return Trace(w1 - w0, busy_us, ops, len(steps), len(launches), lost,
                 gaps, stacks)


def owned_ops(trace: Trace, modules, through=(), kernel_names=None) -> list:
    """The ops of `trace` that belong to a layer.

    With frames, an op belongs where its innermost frame outside `through`
    (modules that only pass a call on from their caller) lies in one of
    `modules`. An entry "module:function" asks besides that a frame of that
    function of the module be open around the launch. An op without frames
    belongs where its kernel name matches the regex `kernel_names`, the
    fallback table; with no table it belongs nowhere."""
    names = re.compile(kernel_names) if kernel_names else None
    owned = []
    for op in trace.ops:
        frames = [f for f in op.frames if f[0] not in through]
        if frames:
            module = frames[0][0]
            open_fns = {f"{m}:{fn}" for m, fn in frames}
            if any(key == module or (key.split(":")[0] == module
                                     and key in open_fns) for key in modules):
                owned.append(op)
        elif names is not None and names.search(op.name):
            owned.append(op)
    return owned
