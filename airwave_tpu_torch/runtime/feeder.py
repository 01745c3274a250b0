"""Double-buffered host->device feed for live streaming.

Port of airwave_tpu/runtime/feeder.py. The JAX feeder leans on
`jax.device_put` returning before the copy ends; PyTorch gives no such
copy for a numpy block, so this one builds it: each input shape gets two
pinned host buffers, a block is copied into the free one and sent to the
card with `non_blocking=True` on a dedicated copy stream, and an event
recorded after the copy is what the compute stream waits on before the
step reads the block. So while the card renders block N, block N+1 is
already crossing PCIe.

Two hazards are handled here:
  - a pinned buffer is refilled only after the copy that last read it has
    finished (its event is synchronised first);
  - the staged device tensor is allocated on the copy stream and read on
    the compute stream, so `record_stream` tells the caching allocator not
    to hand its memory out again until the compute stream is done with it.

Copying into pinned memory is host time; it overlaps the card only because
the previous step's launches return before its kernels finish. So a
step_fn whose state is read on the host between steps serialises the
loop. On device="cpu" the block is copied into a tensor and no stream is
used. On a CUDA device nothing falls back: a failed copy or step raises.

Usage:
    feeder = DeviceFeeder(step_fn, state)
    feeder.prime(first_block)
    out = feeder.step(next_block)   # returns block N's output, stages N+1
    ...
    last = feeder.flush()
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device


class DeviceFeeder:
    def __init__(self, step_fn: Callable, state: Any,
                 device: "torch.device | str" = DEFAULT_DEVICE) -> None:
        """step_fn(state, x_device) -> (state', y_device)."""
        self.step_fn = step_fn
        self.state = state
        self.device = resolve_device(device)
        self._staged: Optional[Tuple[torch.Tensor, Any]] = None
        self.steps = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # (shape, dtype) -> two pinned buffers, the event of the copy that
        # last read each (None before its first use), the next one to fill.
        self._pinned: Dict[tuple, List[torch.Tensor]] = {}
        self._read_events: Dict[tuple, List[Optional[torch.cuda.Event]]] = {}
        self._turn: Dict[tuple, int] = {}

    @property
    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory held by the staging buffers."""
        return sum(b.numel() * b.element_size()
                   for bufs in self._pinned.values() for b in bufs)

    def _put(self, x: np.ndarray):
        x = np.ascontiguousarray(x)
        if self._copy_stream is None:
            return torch.from_numpy(x.copy()), None
        key = (x.shape, x.dtype.str)
        if key not in self._pinned:
            dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            self._pinned[key] = [
                torch.empty(x.shape, dtype=dtype, pin_memory=True)
                for _ in range(2)
            ]
            self._read_events[key] = [None, None]
            self._turn[key] = 0
        i = self._turn[key]
        self._turn[key] = 1 - i
        buf = self._pinned[key][i]
        last_read = self._read_events[key][i]
        if last_read is not None:
            last_read.synchronize()
        np.copyto(buf.numpy(), x)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            dev.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._read_events[key][i] = done
        return dev, done

    def prime(self, x: np.ndarray) -> None:
        """Stage the first block (starts its transfer immediately)."""
        assert self._staged is None, "already primed"
        self._staged = self._put(x)

    def step(self, next_x: Optional[np.ndarray]):
        """Render the staged block; stage `next_x` while it runs.

        Returns the rendered output as a device tensor (fetch with .cpu()
        when needed — keeping it on the device preserves pipelining).
        """
        assert self._staged is not None, "prime() first"
        current, copied = self._staged
        # Stage the next transfer BEFORE dispatching compute so the copy and
        # the step overlap.
        self._staged = self._put(next_x) if next_x is not None else None
        if copied is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(copied)
            current.record_stream(compute)
        self.state, y = self.step_fn(self.state, current)
        self.steps += 1
        return y

    def flush(self):
        """Render the final staged block (if any)."""
        if self._staged is None:
            return None
        return self.step(None)
