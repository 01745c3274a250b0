"""Entry `chain`: one step of the binaural chain, BinauralChain.forward.

Built only through the program's public builders: the renderer (the channel
map and ops/upols.make_conv_params) from a 14-channel bank made on the card
from the seed, the EQ (ops/biquad_design.design_cascade, then
ops/eq_block.make_eq_params), the state makers, and the chain module. The
configuration's `blocks_per_step` picks the tier: 1 is the zero-latency
single-block step (upols.conv_step, then eq_block.eq_step); M > 1 the paged
bake step with the EQ folded into the synthesis
(eq_block.eq_folded_paged_round).
"""

from __future__ import annotations


def eq_definition(eq: dict):
    """The configuration's EQ as the program's EqualizerDefinition."""
    from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                          FilterType)

    kinds = {"peaking": FilterType.PEAKING, "low_shelf": FilterType.LOW_SHELF,
             "high_shelf": FilterType.HIGH_SHELF}
    filters = tuple(
        EqualizerFilter(i + 1, i + 1, f.get("enabled", True), kinds[f["type"]],
                        float(f["frequency_hz"]), float(f["gain_db"]),
                        float(f["q"]))
        for i, f in enumerate(eq["filters"]))
    return EqualizerDefinition(float(eq["preamp_db"]), filters)


def make_bank(config: dict, seed: int, device):
    """The raw [channels, taps] bank, bank_scale * N(0, 1) with a direct tap
    of bank_direct_tap, drawn on `device` in one call; returned on the host
    as float32 numpy, the array both the program and the reference read."""
    import torch

    from perfbench.core.traffic import device_generator

    gen = device_generator(seed, "weights", device)
    bank = torch.randn((config["hrir_channels"], config["hrir_taps"]),
                       generator=gen, device=device)
    bank.mul_(float(config["bank_scale"]))
    bank[:, 0] += float(config["bank_direct_tap"])
    return bank.cpu().numpy()


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from airwave_tpu_torch import apply_precision_policy
        from airwave_tpu_torch.assets import channel_maps
        from airwave_tpu_torch.graph.renderer import prepare_renderer
        from airwave_tpu_torch.io.wav import WAVData
        from airwave_tpu_torch.models.binaural import BinauralChain, ChainState
        from airwave_tpu_torch.ops import biquad_design, eq_block, upols

        apply_precision_policy()
        B = int(traffic["lanes"])
        T = int(config["block_size"])
        M = int(config["blocks_per_step"])
        rate = float(config["sample_rate"])
        self.bank = make_bank(config, seed, device)
        self.eq_enabled = bool(traffic["eq_enabled"])
        layout = channel_maps.detect_layout(config["speakers"])
        renderer = prepare_renderer(WAVData(rate, self.bank), layout, rate, T,
                                    lookahead=M, device=device)
        preamp, coeffs = biquad_design.design_cascade(
            eq_definition(config["eq"]), rate)
        eq = eq_block.make_eq_params(coeffs, preamp, T, device=device)
        self.chain = BinauralChain(renderer.conv_params, eq, eq,
                                   config["eq_transition_frames"], T,
                                   blocks_per_step=M,
                                   eq_enabled=self.eq_enabled)
        S, P = renderer.num_speakers, renderer.partition_count
        conv = (upols.make_conv_state_paged(B, S, P, T, M, device) if M > 1
                else upols.make_conv_state(B, S, P, T, device))
        self.state = ChainState(conv=conv, eq=eq_block.make_eq_state(
            B, config["ears"], device=device))
        self.step_shape = (B, S, M, T) if M > 1 else (B, S, T)
        self.frames_per_step = M * T

    def step(self, x):
        """The timed call: one chain step on the carry."""
        self.state, y = self.chain(self.state, x)
        return y

    def lane_inputs(self, x_lanes):
        """[L, S, (M,) T] step inputs -> [L, S, frames] in time order."""
        return x_lanes.reshape(x_lanes.shape[0], x_lanes.shape[1], -1)

    def lane_outputs(self, y_lanes):
        """[L, (M,) E, T] step outputs -> [L, E, frames] in time order."""
        if y_lanes.dim() == 4:
            y_lanes = y_lanes.permute(0, 2, 1, 3)
        return y_lanes.reshape(y_lanes.shape[0], y_lanes.shape[1], -1)

    def reference_inputs(self, config: dict) -> dict:
        """What the reference is handed: the raw bank and the definitions."""
        return {"bank": self.bank, "layout": config["layout"],
                "eq": config["eq"] if self.eq_enabled else None,
                "sample_rate": float(config["sample_rate"])}

    def free(self) -> None:
        self.chain = self.state = None
