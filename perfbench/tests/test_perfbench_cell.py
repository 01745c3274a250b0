"""The harness's loop end to end on the CPU at the tiny sizes: the result
line's keys (the CPU's numbers are no device metric and are not kept), the
traced run's per-layer keys, and the command line's refusals."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(tiny_spec, cell):
    result, checks = run_tiny(tiny_spec, cell, 2**31 + 11, 0.2, False)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert {"x_realtime", "setup_s"} <= set(result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [c.name for c in checks] == ["worst_rel_rms", "nonfinite_checksums"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_keys(tiny_spec, cell):
    result, _ = run_tiny(tiny_spec, cell, 5, 0.1, True)
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # The CPU has no device records: no device metric is read from it.
    names = set(result["metrics"])
    per_layer = tiny_spec.cell_metrics(cell, "per_layer")
    assert not names & {m["name"] for m in per_layer
                        if m["source"] == "device_trace"}
    assert names == {m["name"] for m in per_layer
                     if m["source"] != "device_trace"}


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "ring.eq.b8192",
         "--seed", "1", "--seconds", "1", "--trace", "0", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "airwave_tpu_torch" in out.stderr
