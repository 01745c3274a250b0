"""The port's chain profiler and serving tools on the CPU:
tools/profile_chain (scripts/profile_chain.py), tools/serve_soak
(tests/test_soak.py:test_render_server_soak) and tools/serve_scale
(scripts/measure_serve_scale.py).

Each runs at CPU-tiny widths with --cpu, with windows of at most 3 s (their
card runs are chip_smoke.py's profile_chain, serve_soak and serve_scale
phases); without --cpu they refuse to run where there is no card. The
profiler's argument errors are the JAX script's, word for word, and its
printed rows and JSON keys follow the script's."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading

import pytest
import torch

from airwave_tpu_torch.runtime import stream_pool
from airwave_tpu_torch.tools import profile_chain, serve_scale, serve_soak, soak
from _torch_sigpipe import sigpipe_ignored  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROFILER = os.path.join(REPO, "scripts", "profile_chain.py")
TINY = ["--cpu", "--batch", "4", "--hrir-seconds", "0.01"]
# scripts/profile_chain.py's row: ms/block, ms total, count, name.
ROW = re.compile(r"^ +\d+\.\d{4} ms/block +\d+\.\d{2} ms total x\d+ +\S")
HEADER = re.compile(r"^# host time per CPU op over (\d+) calls x (\d+) blocks "
                    r"\(B=4, M=(\d+), hrir_seconds=0\.01\)$")


def run_main(main, argv) -> tuple:
    """(exit code, printed lines) of a tool's main(argv) in process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


@pytest.mark.parametrize("argv,blocks,M", [
    ([], 16, 8),
    (["--pool"], 16, 1),
    (["--pool", "--pool-blocks", "2", "--blocks", "3"], 4, 2),
])
def test_profile_chain_rows_and_keys(tmp_path, argv, blocks, M):
    """The bake (M=8) and the pool's round at both tiers: the script's
    comment line, non-empty rows in its format (on the CPU the CPU ops by
    self time), the JSON line with its keys and device_ms_per_block, and
    the Chrome trace in trace_dir."""
    logdir = str(tmp_path / "trace")
    rc, lines = run_main(profile_chain.main,
                         [*TINY, *argv, "--top", "6", "--logdir", logdir])
    assert rc == 0
    header = HEADER.match(lines[0])
    assert header and header.groups() == ("2", str(blocks), str(M)), lines[0]
    rows = lines[1:-1]
    assert 1 <= len(rows) <= 6 and all(ROW.match(r) for r in rows), rows
    result = json.loads(lines[-1])
    assert set(result) == {"trace_dir", "sum_listed_ms_per_block",
                           "device_ms_per_block", "device"}
    assert result["trace_dir"] == logdir
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    assert result["sum_listed_ms_per_block"] > 0
    # A CPU run measures no device time.
    assert result["device_ms_per_block"] == "not measured"
    assert result["device"] == "cpu"
    listed = sum(float(r.split()[0]) for r in rows)
    assert abs(listed - result["sum_listed_ms_per_block"]) <= 1e-3 * len(rows)


def test_headline_chain_is_the_bench_chain():
    """headline_chain is bench.py:build's chain: the seeded bank's shapes
    and direct tap, the bench EQ, the paged state at M > 1 and the ring
    state at M = 1; the bake's call advances the carry it was given."""
    chain, state, x = profile_chain.headline_chain(0, "cpu", 4, 2, 0.01)
    assert x.shape == (4, 2, 2, 512) and hasattr(state.conv, "pages")
    assert chain.blocks_per_step == 2
    hrir = profile_chain.bake_hrir(0, 2, 0.01)
    assert hrir.shape == (2, 2, 480) and (hrir[:, :, 0] > 0.7).all()
    assert profile_chain.bake_hrir(0, 2).shape == (2, 2, 4320)
    chain1, state1, x1 = profile_chain.headline_chain(0, "cpu", 4, 1, 0.01)
    assert x1.shape == (4, 2, 512) and hasattr(state1.conv, "fdl")
    call = profile_chain.bake_call(chain1, state1, x1, 2)
    acc = call()
    assert acc.shape == (8, 128) and torch.isfinite(acc).all()
    assert state1.conv.fdl.any()  # the ring step writes the line in place
    with pytest.raises(ValueError, match="multiple of --blocks-per-step"):
        profile_chain.bake_call(chain, state, x, 3)


@pytest.mark.parametrize("argv", [
    ["--pool-blocks", "2"],
    ["--pool", "--pool-blocks", "2", "--blocks-per-step", "4"],
    ["--pool", "--pool-groups", "0"],
    ["--pool-groups", "2"],
    ["--pool", "--pool-groups", "3", "--batch", "8"],
])
def test_profile_chain_argument_errors_match_the_script(capsys, argv):
    """Each of scripts/profile_chain.py:94-107's argument errors, word for
    word, and the same exit code (argparse's 2)."""
    jax = subprocess.run([sys.executable, JAX_PROFILER, *argv],
                         capture_output=True, text=True, timeout=60)
    with pytest.raises(SystemExit) as exc:
        profile_chain.parse_args(argv)
    assert exc.value.code == jax.returncode == 2
    want = jax.stderr.strip().splitlines()[-1].split("error: ", 1)[1]
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.split("error: ", 1)[1] == want


def test_profile_chain_defaults_are_the_scripts():
    args = profile_chain.parse_args([])
    assert (args.batch, args.blocks, args.blocks_per_step, args.hrir_seconds,
            args.speakers, args.calls, args.pool, args.pool_groups,
            args.top, args.logdir) == (8192, 16, 8, None, 2, 2, False, 1,
                                       40, None)
    assert profile_chain.parse_args(["--pool"]).blocks_per_step == 1
    assert profile_chain.parse_args(
        ["--pool", "--pool-blocks", "8"]).blocks_per_step == 8
    assert profile_chain.parse_args(["--cpu"]).device == "cpu"


@pytest.mark.parametrize("M,groups", serve_soak.TIERS)
def test_serve_soak_passes_at_both_tiers(M, groups):
    """The test's fixture (12 lanes, block 64, the 300- and 700-tap banks)
    held 3 s: every criterion of tests/test_soak.py met, at least one
    retarget, and its JSON line."""
    rc, lines = run_main(serve_soak.main, ["--cpu", "--seconds", "3",
                                           "--blocks-per-step", str(M),
                                           "--groups", str(groups)])
    result = json.loads(lines[-1])
    assert rc == 0 and result["pass"] is True, result
    assert (result["blocks_per_step"], result["groups"]) == (M, groups)
    assert result["clients"] >= 3 and result["frames"] > 0
    assert result["waves"] >= 5 and result["retargets"] >= 1, result
    assert result["pump_errors"] == result["render_errors"] == 0
    assert result["pump_thread_alive"] is True
    assert result["max_streams"] == 12 and result["block"] == 64
    assert result["hrir_taps"] == [300, 700][:groups]
    assert result["device"] == "cpu" and "failures" not in result


def test_serve_soak_fails_on_a_render_fault(monkeypatch):
    """A pool round that raises once in the pump thread makes the soak
    fail (exit 1) with the pump and render errors on its line, and only
    by them: the lost steps come out as silence, so every client still
    completes and no lane is left attached."""
    real = stream_pool.pool_step_body
    fired = []

    def flaky(*args, **kwargs):
        if not fired and threading.current_thread() is not \
                threading.main_thread():
            fired.append(True)
            raise RuntimeError("injected device fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(stream_pool, "pool_step_body", flaky)
    rc, lines = run_main(serve_soak.main, ["--cpu", "--seconds", "1",
                                           "--blocks-per-step", "1",
                                           "--groups", "2"])
    result = json.loads(lines[-1])
    assert fired and rc == 1 and result["pass"] is False
    assert result["pump_errors"] >= 1 and result["render_errors"] >= 1
    assert result["failures"] == [f"pump_errors {result['pump_errors']}",
                                  f"render_errors {result['render_errors']}"]


@pytest.mark.parametrize("waves,memory,failed", [
    (1, {"first_wave": {"requested_bytes": 8}, "end": {"requested_bytes": 8}},
     "the window ended at wave 1, before the live-tensor baseline (wave 7)"),
    (9, {"baseline": {"requested_bytes": 8, "count": 2},
         "end": {"requested_bytes": 8, "count": 2}}, None),
    (9, {"baseline": {"requested_bytes": 8, "count": 2},
         "end": {"requested_bytes": 9, "count": 2}},
     "device memory grew: requested_bytes 8 -> 9"),
])
def test_serve_soak_memory_check_needs_the_wave_7_baseline(waves, memory,
                                                           failed):
    """The card's live-tensor check: a window that ended before the 7th
    wave has no baseline and fails; past it the end may not exceed the
    baseline."""
    assert serve_soak.memory_failures(memory, waves) == (
        [failed] if failed else [])


def test_profile_takes_a_call_that_returns_nothing(tmp_path):
    """profile() traces a call that returns None (the warm-up call and the
    traced ones all run) and writes its Chrome trace."""
    ran = []

    def call():
        ran.append(torch.ones(64).sum())

    result = profile_chain.profile(call, "cpu", 2, 1, top=None,
                                   logdir=str(tmp_path))
    assert len(ran) == 3 and result["rows"] and not result["on_card"]
    assert result["device_ms_per_block"] == "not measured"
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_serve_soak_builds_the_tests_pool():
    """build() makes the test's pools: a grouped ring pool of two banks of
    different lengths, ring_blocks = 4 M, the EQs +3 and -2 dB, and the
    x0.85 / x1.0 swap targets of each group's bank."""
    import numpy as np

    rng = np.random.default_rng(23)
    banks = [serve_soak.seeded_bank(rng, 300),
             serve_soak.seeded_bank(np.random.default_rng(24), 700)]
    pool, swaps = serve_soak.build(banks, device="cpu")
    assert pool.groups == 2 and pool.max_streams == 12
    assert pool.renderers[0].partition_count != pool.renderers[1].partition_count
    soak.settle_eq(pool)  # the construction-time ramp run to its end
    assert [rt.active.definition for rt in pool.eq_runtimes] == [
        serve_soak.eq_definition(3.0), serve_soak.eq_definition(-2.0)]
    assert pool.assembler.capacity == 4 * 64
    assert [[s.partition_count for s in pair] for pair in swaps] == [
        [r.partition_count] * 2 for r in pool.renderers]
    with pytest.raises(SystemExit):
        serve_soak.main(["--cpu", "--groups", "2"])


def test_serve_scale_completes_with_no_server_error():
    rc, lines = run_main(serve_scale.main, ["--cpu", "--clients", "8",
                                            "--blocks-each", "6"])
    result = json.loads(lines[-1])
    assert rc == 0
    assert set(result) == {"io_mode", "pool_streams", "load", "server",
                           "harness_wall_s", "device"}
    assert result["load"]["completed"] == 8 and result["load"]["failed"] == 0
    server = result["server"]
    assert server["connections_served"] == 8
    assert server["protocol_errors"] == server["pump_errors"] == 0
    assert server["rejected_full"] == server["truncated_closes"] == 0
    assert result["pool_streams"] == 16 and result["io_mode"] == "selector"
    assert result["device"] == "cpu"


@pytest.mark.parametrize("tool,argv", [
    (profile_chain, ["--batch", "4"]),
    (serve_soak, ["--seconds", "0.1"]),
    (serve_scale, ["--clients", "2"]),
])
def test_tools_need_a_card_unless_told_cpu(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tool would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(argv)
