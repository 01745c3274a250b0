"""Tracing / profiling utilities.

Port of airwave_tpu/utils/profiling.py: per-step wall timing on the host,
realtime-multiple accounting, and an optional torch.profiler trace context
(device_trace). The kernels stay instrumentation-free.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional


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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the CPU and (when a card is present) CUDA
    activity inside the context, written to `log_dir` as a Chrome trace
    for TensorBoard; a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
