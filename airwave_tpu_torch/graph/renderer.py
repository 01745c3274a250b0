"""Spatial renderer preparation: HRIR WAV -> device convolution params.

Port of airwave_tpu/graph/renderer.py. The activation math of the
reference (Airwave/HRIRManager.swift:347-448) is host numpy and unchanged:
choose a channel map from the HRIR channel count, resolve (left-ear,
right-ear) HRIR channels per virtual speaker of the input layout, resample
each HRIR to the output rate, and build one batched bank [S, 2, L]. Only
the published RendererState differs: it holds the port's torch ConvParams
on `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from airwave_tpu_torch.assets import channel_maps as cm
from airwave_tpu_torch.device import (DEFAULT_DEVICE, apply_precision_policy,
                                      resolve_device)
from airwave_tpu_torch.io.wav import WAVData
from airwave_tpu_torch.ops import resample, upols
from airwave_tpu_torch.utils.errors import AirwaveError


class RendererPreparationError(AirwaveError):
    pass


@dataclasses.dataclass(frozen=True)
class RendererState:
    """Immutable published renderer (ref HRIRManager.swift:123-131).

    `speakers` holds the RESOLVED virtual speakers in input-channel order;
    a layout channel with no HRIR mapping is skipped at preparation (e.g.
    the 7.1.4 heights against the height-less hesuvi14 map), so
    `input_indices` records which of the layout's `input_channels` feed the
    render. `lookahead` is the M-block lookahead the conv params were built
    for (1 = the zero-added-latency shape; M > 1 feeds the paged pool
    tier)."""

    conv_params: upols.ConvParams
    speakers: tuple
    sample_rate: float
    block_size: int
    generation: int = 0
    input_channels: int = 0      # layout channel count (0 = num_speakers)
    input_indices: tuple = ()    # layout-channel index per resolved speaker
    lookahead: int = 1

    @property
    def num_speakers(self) -> int:
        return len(self.speakers)

    @property
    def partition_count(self) -> int:
        return self.conv_params.partition_count

    @property
    def layout_channels(self) -> int:
        return self.input_channels or self.num_speakers

    @property
    def device(self) -> torch.device:
        return self.conv_params.Gflip2.device

    def select_input(self, chunk):
        """Map a [layout_channels, n] chunk onto the resolved speakers
        ([num_speakers, n]); already-resolved chunks pass through."""
        if (chunk.shape[0] == self.layout_channels
                and chunk.shape[0] != self.num_speakers):
            return chunk[list(self.input_indices)]
        return chunk


def build_hrir_time_domain(
    wav: WAVData,
    input_layout: cm.InputLayout,
    output_sample_rate: float,
    channel_map: Optional[cm.HRIRChannelMap] = None,
    resampler=resample.resample_linear,
    with_speakers: bool = False,
):
    """Resolve + resample HRIRs into [S, 2, L] float32 (speaker, ear, taps).

    A layout channel the map cannot resolve is skipped, as the reference's
    activation loop does (HRIRManager.swift:370-372); preparation fails
    only when no speaker resolves. With with_speakers=True returns (bank,
    resolved_speakers, layout_indices)."""
    if channel_map is None:
        channel_map = cm.select_channel_map(wav.channel_count,
                                            input_layout.channels)
    rows, speakers, layout_indices = [], [], []
    for pos, speaker in enumerate(input_layout.channels):
        indices = channel_map.indices(speaker)
        if indices is None:
            continue  # unmapped (e.g. height channel): skipped, not fatal
        left_idx, right_idx = indices
        if not (0 <= left_idx < wav.channel_count
                and 0 <= right_idx < wav.channel_count):
            raise RendererPreparationError(
                f"HRIR channel indices {indices} out of range for "
                f"{wav.channel_count}-channel file"
            )
        left = resampler(wav.audio[left_idx], wav.sample_rate,
                         output_sample_rate)
        right = resampler(wav.audio[right_idx], wav.sample_rate,
                          output_sample_rate)
        rows.append(np.stack([left, right]))
        speakers.append(speaker)
        layout_indices.append(pos)
    if not rows:
        raise RendererPreparationError(
            f"No HRIR mapping found for any speaker of layout "
            f"{input_layout.name!r}"
        )
    bank = np.stack(rows).astype(np.float32)
    if with_speakers:
        return bank, tuple(speakers), tuple(layout_indices)
    return bank


def prepare_renderer(
    wav: WAVData,
    input_layout: cm.InputLayout,
    output_sample_rate: float,
    block_size: int = 512,
    channel_map: Optional[cm.HRIRChannelMap] = None,
    generation: int = 0,
    resampler=resample.resample_linear,
    partition_bucketing: str = "exact",
    lookahead: int = 1,
    partitions: Optional[int] = None,
    device: "torch.device | str" = DEFAULT_DEVICE,
) -> RendererState:
    """Prepare the renderer's conv params on `device` (the card by default).

    partition_bucketing: "exact" (default) uses the HRIR's true partition
    count; "pow2" pads it to a power of two (the reference's
    bucket-for-reuse policy). lookahead=M builds the params for the M-block
    paged paths (M-1 zero tail partitions). partitions=N forces the
    delay-line partition count (upols.make_conv_params)."""
    device = resolve_device(device)
    apply_precision_policy()
    hrir_td, speakers, layout_indices = build_hrir_time_domain(
        wav, input_layout, output_sample_rate, channel_map, resampler,
        with_speakers=True,
    )
    params = upols.make_conv_params(
        hrir_td, block_size, pad_to_pow2=(partition_bucketing == "pow2"),
        lookahead=lookahead, partitions=partitions, device=device,
    )
    return RendererState(
        conv_params=params,
        speakers=speakers,
        sample_rate=float(output_sample_rate),
        block_size=block_size,
        generation=generation,
        input_channels=len(input_layout.channels),
        input_indices=layout_indices,
        lookahead=int(lookahead),
    )
