"""utils/memory_planner and tools/plan_capacity of the port against the
JAX package's, on the CPU.

The estimators and pool_capacity are the JAX package's arithmetic: over a
grid of shapes (tiers, bank lengths, groups, mesh devices, budgets, a
given calibration dict) the port returns the same values. The bake ladder
is the JAX ladder without its acc_chunk-only and max_unroll rungs, pruned
by the same rule. The calibration measures the card's allocator
(cuda_pool_round_memory), so on a CPU pool it raises; its card test is in
tests/test_torch_cuda.py. `python -m airwave_tpu_torch.tools.plan_capacity`
without --calibrate prints the numbers scripts/plan_capacity.py prints.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from airwave_tpu.utils import memory_planner as jmp
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io.apo import EqualizerDefinition
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.ops import upols as tupols
from airwave_tpu_torch.runtime.stream_pool import StreamPool as TPool
from airwave_tpu_torch.tools import plan_capacity as tplan
from airwave_tpu_torch.utils import memory_planner as tmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Rungs of the JAX ladder the port drops: accumulation chunking without a
# batch split, and the scan-unroll cap.
DROPPED = ("acc chunking", "minimum-memory")

SHAPES = [(2, 4320, 512, 1), (2, 4320, 512, 8), (8, 48_000, 512, 8),
          (2, 300, 64, 1), (2, 700, 64, 4), (4, 1488, 256, 2)]


@pytest.mark.parametrize("speakers,taps,block,m", SHAPES)
def test_estimators_equal_jax(speakers, taps, block, m):
    assert tmp.paged_partitions(taps, block, m) == jmp.paged_partitions(
        taps, block, m)
    for batch in (1, 16, 8192, 16_384):
        for chunk in (0, 1, 2, 5):
            assert tuple(tmp.estimate_paged_bake(
                batch, speakers, taps, block, m, acc_chunk=chunk)) == tuple(
                jmp.estimate_paged_bake(batch, speakers, taps, block, m,
                                        acc_chunk=chunk))
    assert tmp.estimate_pool_lane_bytes(speakers, taps, block, m) == (
        jmp.estimate_pool_lane_bytes(speakers, taps, block, m))


def _calibration(per_lane, fixed):
    return {"per_lane_bytes": per_lane, "fixed_bytes": fixed,
            "carry_bytes_exact": 1, "probe_batch": 512, "backend": "cuda",
            "rounds": {"steady": {"per_lane_bytes": per_lane // 2,
                                  "fixed_bytes": fixed // 2,
                                  "peak_bytes": per_lane * 256},
                       "hotswap": {"per_lane_bytes": per_lane,
                                   "fixed_bytes": fixed,
                                   "peak_bytes": per_lane * 512}}}


@pytest.mark.parametrize("speakers,taps,block,m", SHAPES)
def test_pool_capacity_equals_jax(speakers, taps, block, m):
    for groups, mesh, hbm in ((1, 1, 16 * 2**30), (3, 4, 16 * 2**30),
                              (2, 1, 80e9), (1, 1, 2**20), (4, 2, 24e9)):
        for calibration in (None, _calibration(151_000, 9_000_000),
                            {"per_lane_bytes": 90_001, "fixed_bytes": 77}):
            kw = dict(lookahead=m, groups=groups, hbm_bytes=hbm,
                      mesh_devices=mesh, calibration=calibration)
            assert tmp.pool_capacity(speakers, taps, block, **kw) == (
                jmp.pool_capacity(speakers, taps, block, **kw))
    het = dict(groups=2, hbm_bytes=16 * 2**30, lookahead=m)
    assert tmp.pool_capacity(speakers, [taps, taps // 3 + 1], block,
                             **het) == jmp.pool_capacity(
        speakers, [taps, taps // 3 + 1], block, **het)
    for mod in (tmp, jmp):
        with pytest.raises(ValueError, match="entries"):
            mod.pool_capacity(speakers, [taps] * 3, block, groups=2,
                              hbm_bytes=1e9)


def test_partitions_match_the_port_banks():
    """The planner's partition counts are the port's renderer banks'."""
    for taps in (300, 1488, 4320):
        hrir = np.zeros((2, 2, taps), np.float32)
        real = tupols.make_conv_params(hrir, 512, pad_to_pow2=False,
                                       device="cpu").partition_count
        plan = tmp.pool_capacity(2, taps, 512, hbm_bytes=16 * 2**30)
        assert plan["partitions"] == real
    for taps, m in ((4320, 4), (48_000, 8)):
        hrir = np.zeros((2, 2, taps), np.float32)
        real = tupols.make_conv_params(hrir, 512, pad_to_pow2=False,
                                       lookahead=m,
                                       device="cpu").partition_count
        assert tmp.paged_partitions(taps, 512, m) == real


def _kept(reason: str) -> bool:
    return not any(reason.startswith(d) for d in DROPPED)


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_ladder_is_the_jax_ladder_minus_the_dropped_rungs(m):
    want = [(a.lookahead, a.reason, a.batch_split)
            for a in jmp.plan_paged_bake(16_384, 2, 48_000, 512, m)
            if _kept(a.reason)]
    got = tmp.plan_paged_bake(16_384, 2, 48_000, 512, m)
    assert [(a.lookahead, a.reason, a.batch_split) for a in got] == want
    assert all(a.acc_chunk == 0 and a.max_unroll == 0 for a in got)
    assert got[0] == tmp.PlanAttempt(m, 0, "full speed")
    assert got[-1].batch_split == 4
    assert tmp.PlanAttempt._fields == jmp.PlanAttempt._fields


@pytest.mark.parametrize("batch,taps,hbm", [
    (8192, 4320, 1e12), (16_384, 48_000, 16e9), (16_384, 48_000, 1e9),
    (16_384, 4320, 12e9), (4096, 48_000, 6e9)])
def test_ladder_pruning_follows_the_jax_rule(batch, taps, hbm):
    """The same rule as the JAX planner, on the port's rungs and their
    (unchunked) estimates: keep what fits the headroom, everything when
    nothing fits, and always the final fallback."""
    full = tmp.plan_paged_bake(batch, 2, taps, 512, 8)
    budget = 0.92 * hbm
    fits = [a for a in full
            if jmp.estimate_paged_bake(batch // a.batch_split, 2, taps, 512,
                                       a.lookahead, 0).total_bytes <= budget]
    want = fits if fits else full
    if want[-1] != full[-1]:
        want = want + [full[-1]]
    assert tmp.plan_paged_bake(batch, 2, taps, 512, 8, hbm_bytes=hbm) == want


def _cpu_pool(M=1):
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((14, 300)) * 0.05).astype(np.float32)
    renderer = tprepare(TWAVData(48_000.0, audio), tcm.STEREO, 48_000.0, 64,
                        lookahead=M, device="cpu")
    return TPool(16, 48_000.0, renderer,
                 eq_definition=EqualizerDefinition(preamp_db=-3.0),
                 block_size=64, blocks_per_step=M, device="cpu")


@pytest.mark.parametrize("M", [1, 4])
def test_calibration_needs_a_cuda_pool(M):
    with pytest.raises(ValueError, match="needs a CUDA pool"):
        tmp.cuda_pool_round_memory(_cpu_pool(M))


@pytest.mark.parametrize("M", [1, 4])
def test_probe_rounds_run_on_the_pool_operands(M):
    """The rounds the calibration measures, run on the CPU: every kind
    renders [lanes, (M,) ears, T] and leaves the pool's own carry as it
    was."""
    pool = _cpu_pool(M)
    before = [t.clone() for t in (pool._state.conv.pages if M > 1
                                  else (pool._state.conv.fdl,))]
    for name in ("steady", "eq_xfade", "hotswap"):
        state, y = tmp.run_round(pool, name, 8)
        assert tuple(y.shape) == ((8, M, 2, 64) if M > 1 else (8, 2, 64))
        assert torch.isfinite(y).all()
    after = (pool._state.conv.pages if M > 1 else (pool._state.conv.fdl,))
    for a, b in zip(before, after):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M", [1, 4])
def test_round_on_a_given_carry_and_input(M):
    """run_round(state=, blocks=) continues the carry it is given on the
    input it is given: on the pool's own fresh carry it renders what a
    fresh probe carry of the pool's lanes renders, and a second round on
    the first's carry differs from the first (the history is kept)."""
    pool = _cpu_pool(M)
    x = torch.from_numpy(np.random.default_rng(M).standard_normal(
        (16, 2, M, 64) if M > 1 else (16, 2, 64)).astype(np.float32))
    with torch.inference_mode():  # as the pool runs (the ring writes in place)
        for name in tmp.round_kinds(pool):
            state, y = tmp.run_round(pool, name, state=pool._state, blocks=x)
            _, fresh = tmp.run_round(pool, name, 16, blocks=x)
            assert torch.equal(y, fresh)
            _, again = tmp.run_round(pool, name, state=state, blocks=x)
            assert not torch.equal(again, y)
            pool = _cpu_pool(M)
    assert tmp.round_kinds(pool, ("hotswap",)) == ["hotswap"]
    with pytest.raises(ValueError, match="unknown round kinds"):
        tmp.round_kinds(pool, ("warmup",))


def test_pool_round_peak_needs_a_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tmp.pool_round_peak(_cpu_pool, "cpu")


def test_device_memory_queries_need_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        tmp.device_hbm_bytes("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tmp.device_hbm_bytes()
        with pytest.raises(RuntimeError, match="is_available"):
            tmp.pool_capacity(2, 4320, 512)  # the budget of the card


def _script_main():
    spec = importlib.util.spec_from_file_location(
        "_plan_capacity_script", os.path.join(REPO, "scripts",
                                              "plan_capacity.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@pytest.mark.parametrize("flags", [
    [], ["--blocks-per-step", "8", "--groups", "4", "--hbm-gb", "16"],
    ["--hrir-seconds", "0.09,0.031", "--groups", "2", "--mesh-devices", "4"],
    ["--speakers", "8", "--hrir-seconds", "1.0", "--blocks-per-step", "8",
     "--headroom", "0.7", "--hbm-gb", "80"],
    ["--hbm-gb", "0.001"],
])
def test_plan_capacity_prints_the_script_numbers(flags, monkeypatch):
    outputs, codes = [], []
    for name, main in (("script", _script_main()), ("port", tplan.main)):
        monkeypatch.setattr(sys, "argv", ["plan_capacity"] + flags)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            codes.append(main() if name == "script" else main(flags))
        outputs.append(json.loads(buf.getvalue()))
    assert codes[0] == codes[1]
    assert outputs[0] == outputs[1]
    assert outputs[1]["calibrated"] is False


def test_plan_capacity_module_runs_without_a_device():
    out = subprocess.run(
        [sys.executable, "-m", "airwave_tpu_torch.tools.plan_capacity",
         "--blocks-per-step", "8", "--hbm-gb", "24"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    plan = json.loads(out.stdout)
    assert plan["max_streams"] > 0 and plan["blocks_per_step"] == 8
    err = subprocess.run(
        [sys.executable, "-m", "airwave_tpu_torch.tools.plan_capacity",
         "--calibrate", "--cpu", "--probe-batch", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert err.returncode == 2 and "needs a CUDA pool" in err.stderr
    for flags, message in ((["--verify", "--cpu"], "needs a CUDA device"),
                           (["--verify", "--mesh-devices", "2"],
                            "--mesh-devices 1")):
        err = subprocess.run(
            [sys.executable, "-m", "airwave_tpu_torch.tools.plan_capacity",
             "--hbm-gb", "0.01", *flags],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert err.returncode == 2 and message in err.stderr, err.stderr
