"""Tracing / profiling utilities.

Port of airwave_tpu/utils/profiling.py: per-step wall timing on the host
and realtime-multiple accounting (RenderProfiler), and the program's spans.

`span(name)` marks a layer of the chain step for torch.profiler: while a
profiler records, it is a `record_function` range, a `user_annotation`
event of the trace on the same clock as the device's records, nested on the
launching thread; otherwise it is one shared null context and costs only
the profiler's enabled check. Nothing turns spans on but a profiler that
records. Every name is a module-level constant beginning with SPAN_PREFIX:

  airwave.chain.step            models/binaural's chain steps
  airwave.conv.analysis         ops/upols: the analysis product and the
                                delay-line write
  airwave.conv.synthesis        ops/upols: the synthesis product
  airwave.mac.single.<route>    kernels/mac_kmajor: a mac_kmajor launch
  airwave.mac.pages.columns<c>  ... a mac_kmajor_pages launch
  airwave.mac.{single,pages}.ref  ... their plain versions (CPU tensors)
  airwave.eq.cascade            ops/eq_block.eq_step
  airwave.eq.recurrence         ops/eq_block.eq_apply_folded
  airwave.build.*               work done once and cached: a MAC launch
                                plan, a weight's split, the kernel library

On a card the profiler also gives each span a device-side range over the
kernels launched inside it (`gpu_user_annotation`): `key_averages()` lists
it as a CUDA row of the span's name, whose time is already its kernels'.
A sum of CUDA rows leaves out the rows whose names begin with SPAN_PREFIX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict

import torch

SPAN_PREFIX = "airwave."
CHAIN_STEP = "airwave.chain.step"
CONV_ANALYSIS = "airwave.conv.analysis"
CONV_SYNTHESIS = "airwave.conv.synthesis"
EQ_CASCADE = "airwave.eq.cascade"
EQ_RECURRENCE = "airwave.eq.recurrence"
BUILD_MAC_PLAN = "airwave.build.mac_plan"
BUILD_WEIGHT_OPERAND = "airwave.build.weight_operand"
BUILD_KERNEL_LIBRARY = "airwave.build.kernel_library"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A torch.profiler range named `name` while a profiler records, else
    a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@dataclasses.dataclass
class StepStats:
    steps: int = 0
    total_seconds: float = 0.0
    min_seconds: float = float("inf")
    max_seconds: float = 0.0

    def record(self, seconds: float) -> None:
        self.steps += 1
        self.total_seconds += seconds
        self.min_seconds = min(self.min_seconds, seconds)
        self.max_seconds = max(self.max_seconds, seconds)

    @property
    def mean_seconds(self) -> float:
        return self.total_seconds / self.steps if self.steps else 0.0


class RenderProfiler:
    """Wall-clock accounting for block steps, kept entirely host-side."""

    def __init__(self, sample_rate: float, block_size: int,
                 batch: int = 1) -> None:
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.batch = batch
        self.stats: Dict[str, StepStats] = {}

    @contextlib.contextmanager
    def step(self, label: str = "render"):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.stats.setdefault(label, StepStats()).record(
                time.perf_counter() - start
            )

    def realtime_multiple(self, label: str = "render") -> float:
        stats = self.stats.get(label)
        if stats is None or stats.total_seconds == 0:
            return 0.0
        audio_seconds = (
            stats.steps * self.block_size * self.batch / self.sample_rate
        )
        return audio_seconds / stats.total_seconds

    def report(self) -> dict:
        return {
            label: {
                "steps": s.steps,
                "mean_ms": round(s.mean_seconds * 1e3, 4),
                "min_ms": round(s.min_seconds * 1e3, 4),
                "max_ms": round(s.max_seconds * 1e3, 4),
                "realtime_multiple": round(self.realtime_multiple(label), 1),
            }
            for label, s in self.stats.items()
        }
