"""Stream-level spatial effect: conv engine + frame adapter + hot swap.

Port of airwave_tpu/graph/spatial_effect.py over the port's
BinauralEngine, on `device` (the card by default). A published immutable
RendererState drives a fixed-block conv engine behind a frame adapter;
callbacks of any size up to max_frames_per_callback become whole blocks.
The EQ is *not* fused here: the live graph applies it after the adapter at
callback granularity, the reference's ordering (AudioEffectGraph.swift:
195-220). The fused conv+EQ step of models/binaural.py is the batched
throughput path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from airwave_tpu_torch.config import DEFAULT_CONFIG, AirwaveConfig
from airwave_tpu_torch.device import DEFAULT_DEVICE
from airwave_tpu_torch.graph.frame_adapter import FrameAdapter
from airwave_tpu_torch.graph.renderer import RendererState
from airwave_tpu_torch.models.binaural import BinauralEngine


class SpatialEffect:
    def __init__(
        self,
        batch: int,
        sample_rate: float,
        block_size: int = 512,
        config: AirwaveConfig = DEFAULT_CONFIG,
        device: "torch.device | str" = DEFAULT_DEVICE,
    ) -> None:
        self.batch = batch
        self.sample_rate = float(sample_rate)
        self.block_size = block_size
        self.config = config
        self.engine = BinauralEngine(batch, sample_rate, block_size,
                                     config=config, device=device)
        self.adapter: Optional[FrameAdapter] = None

    @property
    def is_ready(self) -> bool:
        return self.engine.spatial_ready

    def set_renderer(self, renderer: Optional[RendererState],
                     crossfade: bool = True) -> None:
        """Swap the published renderer. A crossfaded swap (see
        BinauralEngine.set_renderer) keeps the frame adapter's buffered
        samples too, so the stream is continuous end to end; a resetting
        swap drops them with the history (the reference's fresh-pipeline
        semantics)."""
        crossfaded = self.engine.set_renderer(renderer, crossfade=crossfade)
        if renderer is None:
            self.adapter = None
            return
        if (
            self.adapter is None
            or self.adapter.in_channels != renderer.num_speakers
        ):
            self.adapter = FrameAdapter(
                self.engine.process_block,
                self.batch,
                in_channels=renderer.num_speakers,
                out_channels=2,
                block_size=self.block_size,
                max_frames_per_callback=self.config.max_frames_per_callback,
            )
        elif not crossfaded:
            self.adapter.reset()

    def reset(self) -> None:
        self.engine.reset()
        if self.adapter is not None:
            self.adapter.reset()

    def process(self, x: np.ndarray) -> np.ndarray:
        """x [B, C, n] -> [B, 2, n]; mono input duplicated across speakers;
        full layout-channel input (e.g. 12-channel 7.1.4 against a map
        that resolved 8 speakers) selects the mapped rows, and the
        unmapped channels drop."""
        if self.adapter is None:
            raise RuntimeError("spatial effect not ready: no renderer")
        speakers = self.adapter.in_channels
        C = x.shape[1]
        if C < speakers:
            if C != 1:
                raise ValueError(
                    f"input has {C} channels; renderer expects {speakers}"
                )
            x = np.repeat(x, speakers, axis=1)
        elif C > speakers:
            renderer = self.engine.renderer
            if renderer is not None and C == renderer.layout_channels:
                x = x[:, list(renderer.input_indices)]
            else:
                raise ValueError(
                    f"input has {C} channels; renderer expects {speakers}"
                )
        return self.adapter.process(x)
