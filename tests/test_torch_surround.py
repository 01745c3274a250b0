"""7.1 input through the whole 14-channel HeSuVi bank: the port's chain,
made by the program's public functions, against the benchmark's plain
float64 reference for surround input (perfbench/reference/
binaural_surround.py, loaded by its path), on both chain tiers, with and without the EQ, at CPU
sizes (block 128, 300 taps, 8 lanes, 16 blocks), held to the cell's own
limit. Imports no jax and needs no card.

The block is 128 frames and not the benchmark's tiny 32: the EQ's block
recurrence carries fp32 rounding from block to block, and over 16 blocks
of 32 frames it reaches 2.3e-6 rel-RMS with stereo input and 2.9e-6 with
7.1, against 6-12e-7 at 128 frames, so 32 frames would leave the limit no
room."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
BLOCK, TAPS, LANES, BLOCKS = 128, 300, 8, 16
RATE = 48_000.0


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load(BENCH / "reference" / "binaural_surround.py",
            "perfbench_reference_binaural_surround")
CONFIG = json.loads((BENCH / "configs" / "ring_hesuvi_71.json").read_text())
# The cell's own limit on the worst block's rel-RMS.
LIMIT = json.loads((BENCH / "traffic" / "rounds.71.eq.b8192.json")
                   .read_text())["check"]["limit_rel_rms"]


def _bank(seed: int) -> np.ndarray:
    """A seeded [14, TAPS] bank shaped as the configuration's: a direct tap
    plus small noise."""
    bank = (np.random.default_rng(seed).standard_normal((14, TAPS))
            * CONFIG["bank_scale"]).astype(np.float32)
    bank[:, 0] += CONFIG["bank_direct_tap"]
    return bank


def _render(bank, x, blocks_per_step: int, eq_enabled: bool) -> np.ndarray:
    """x [B, 8, BLOCKS*BLOCK] through BinauralChain at 7.1 -> [B, 2, n]."""
    from airwave_tpu_torch.assets import channel_maps
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.io.wav import WAVData
    from airwave_tpu_torch.models.binaural import BinauralChain, ChainState
    from airwave_tpu_torch.ops import biquad_design, eq_block, upols

    chain_entry = _load(BENCH / "entries" / "chain.py", "perfbench_entry_chain")
    M, B = blocks_per_step, x.shape[0]
    layout = channel_maps.detect_layout(8)
    assert layout is channel_maps.SURROUND_7_1
    renderer = prepare_renderer(
        WAVData(RATE, bank), layout, RATE, BLOCK, lookahead=M, device="cpu",
        channel_map=channel_maps.select_channel_map(14, layout.channels))
    assert renderer.speakers == layout.channels
    preamp, coeffs = biquad_design.design_cascade(
        chain_entry.eq_definition(CONFIG["eq"]), RATE)
    eq = eq_block.make_eq_params(coeffs, preamp, BLOCK, device="cpu")
    chain = BinauralChain(renderer.conv_params, eq, eq,
                          CONFIG["eq_transition_frames"], BLOCK,
                          blocks_per_step=M, eq_enabled=eq_enabled)
    S, P = renderer.num_speakers, renderer.partition_count
    conv = (upols.make_conv_state_paged(B, S, P, BLOCK, M, "cpu") if M > 1
            else upols.make_conv_state(B, S, P, BLOCK, "cpu"))
    state = ChainState(conv=conv, eq=eq_block.make_eq_state(B, device="cpu"))
    xt = torch.from_numpy(x)
    outs = []
    with torch.inference_mode():
        for i in range(BLOCKS // M):
            xs = xt[:, :, i * M * BLOCK:(i + 1) * M * BLOCK]
            if M > 1:
                state, y = chain(state, xs.reshape(B, S, M, BLOCK))
                outs.extend(y[:, m] for m in range(M))
            else:
                state, y = chain(state, xs)
                outs.append(y)
    return torch.cat(outs, dim=-1).numpy()


@pytest.mark.parametrize("eq_enabled", [True, False], ids=["eq", "flat"])
@pytest.mark.parametrize("blocks_per_step", [1, 8], ids=["ring", "paged"])
def test_chain_71_agrees_with_the_reference(blocks_per_step, eq_enabled):
    bank = _bank(21 + blocks_per_step)
    x = (np.random.default_rng(5).standard_normal((LANES, 8, BLOCKS * BLOCK))
         * 0.25).astype(np.float32)
    got = _render(bank, x, blocks_per_step, eq_enabled)

    g = torch.from_numpy(ref.responses(
        bank, "7.1", CONFIG["eq"] if eq_enabled else None, RATE))
    history = g.shape[-1] - 1
    seg = np.concatenate([np.zeros((LANES, 8, history)), x], axis=-1)
    want = ref.render(g, torch.from_numpy(seg), BLOCKS * BLOCK).numpy()

    got = got.reshape(LANES, 2, BLOCKS, BLOCK)
    want = want.reshape(LANES, 2, BLOCKS, BLOCK)
    err = np.sqrt(((got - want) ** 2).sum((1, 3)) / (want ** 2).sum((1, 3)))
    assert err.max() <= LIMIT, err.max()


def test_reference_71_table_is_the_hesuvi_14_map():
    from airwave_tpu_torch.assets import channel_maps

    layout = channel_maps.SURROUND_7_1
    m = channel_maps.hesuvi_14_channel(layout.channels)
    assert ref.LAYOUTS["7.1"] == layout.channels
    assert ref.speaker_channels("7.1") == [m.indices(s)
                                           for s in layout.channels]


def test_accuracy_gate_takes_the_71_layout():
    """tools/validate_accuracy --speakers 8 on the CPU: the 7.1 layout by
    detect_layout, 8 speakers resolved from the 14-channel bank, within
    the strict contract of the float64 oracles."""
    from airwave_tpu_torch.tools import validate_accuracy

    result = validate_accuracy.validate(
        ["--device", "cpu", "--speakers", "8", "--batch", "2", "--blocks",
         "3", "--hrir-seconds", "0.02"])
    assert result["speakers"] == 8 and result["layout"] == "7.1 Surround"
    assert result["pass"] and result["value"] <= 1e-5
