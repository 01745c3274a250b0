"""Frame-size adapter: arbitrary callback sizes -> fixed device blocks.

The port's own copy of airwave_tpu/graph/frame_adapter.py (numpy only).

Host-side re-implementation of
the reference's Airwave/RealtimeAudioProcessor.swift:30-191, batched over
streams. Arbitrary positive callback sizes (<= max_frames_per_callback) are
accumulated into a pending block; each full block runs the render step; the
results feed a ring FIFO of capacity max_frames + block; exactly the callback
frame count is drained, zero-filling on underflow. This reproduces the
deliberate <=1-block latency contract (e.g. a 384-sample silent prefix for
128-frame callbacks, ref RealtimeAudioProcessorTests.swift:68-78).

The device never sees ragged shapes: it always steps on [B, C, block] —
so each block step runs on the shapes its kernels were built for.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class FrameAdapter:
    def __init__(
        self,
        render_block: Callable[[np.ndarray], np.ndarray],
        batch: int,
        in_channels: int,
        out_channels: int = 2,
        block_size: int = 512,
        max_frames_per_callback: int = 4096,
    ) -> None:
        assert block_size > 0 and max_frames_per_callback > 0
        self.render_block = render_block
        self.batch = batch
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.block_size = block_size
        self.max_frames_per_callback = max_frames_per_callback
        self.fifo_capacity = max_frames_per_callback + block_size
        self._alloc()

    def _alloc(self) -> None:
        self.pending = np.zeros(
            (self.batch, self.in_channels, self.block_size), np.float32
        )
        self.pending_count = 0
        self.fifo = np.zeros(
            (self.batch, self.out_channels, self.fifo_capacity), np.float32
        )
        self.fifo_read = 0
        self.fifo_count = 0

    def reset(self) -> None:
        """Clear adapter storage (the owner resets the render state,
        ref RealtimeAudioProcessor.swift:121-127)."""
        self._alloc()

    def process(self, x: np.ndarray) -> np.ndarray:
        """x [B, C_in, n] -> y [B, C_out, n] for any 0 < n <= max frames.

        Mono input (C_in == 1 arrays against a 2-channel adapter) is
        duplicated by the caller/graph; here shapes must match exactly.
        """
        x = np.asarray(x, np.float32)
        assert x.ndim == 3 and x.shape[0] == self.batch
        assert x.shape[1] == self.in_channels
        n = x.shape[2]
        if n == 0:
            return np.zeros((self.batch, self.out_channels, 0), np.float32)
        assert n <= self.max_frames_per_callback

        offset = 0
        while offset < n:
            take = min(self.block_size - self.pending_count, n - offset)
            self.pending[:, :, self.pending_count:self.pending_count + take] = (
                x[:, :, offset:offset + take]
            )
            self.pending_count += take
            offset += take
            if self.pending_count == self.block_size:
                self._push(self.render_block(self.pending))
                self.pending_count = 0

        return self._drain(n)

    def _push(self, block: np.ndarray) -> None:
        T = self.block_size
        write = (self.fifo_read + self.fifo_count) % self.fifo_capacity
        first = min(T, self.fifo_capacity - write)
        self.fifo[:, :, write:write + first] = block[:, :, :first]
        if first < T:
            self.fifo[:, :, :T - first] = block[:, :, first:]
        self.fifo_count += T

    def _drain(self, n: int) -> np.ndarray:
        out = np.zeros((self.batch, self.out_channels, n), np.float32)
        available = min(n, self.fifo_count)
        if available > 0:
            r = self.fifo_read
            first = min(available, self.fifo_capacity - r)
            out[:, :, :first] = self.fifo[:, :, r:r + first]
            if first < available:
                out[:, :, first:available] = self.fifo[:, :, :available - first]
            self.fifo_read = (r + available) % self.fifo_capacity
            self.fifo_count -= available
        # Frames beyond `available` stay zero (underflow contract).
        return out
