"""The control of the comparison, on the card at each cell's own size: the
program at its own lower precision tier (AIRWAVE_MATMUL_PRECISION=high,
bf16x3 on the tensor cores) in the program's place, on three seeds, must
come out not correct; the configuration's own tier on the same seeds must
come out correct. Each run is a whole run of the command, at the
benchmark's run_seconds.

    python -m pytest perfbench/tests -m cuda -q
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

SEEDS = [2147483659, 2400000017, 3000000019]
CELLS = ["bake.eq.b16384", "ring.eq.b8192", "ring.flat.b32768"]


def run(cell, seed, *extra):
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", "0", *extra],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cuda_card, cell, seed):
    result = run(cell, seed, "--tier", "high")
    assert result["correct"] is False
    check = result["checks"]["worst_rel_rms"]
    assert check["value"] > check["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_configuration_tier_is_correct(cuda_card, cell):
    result = run(cell, SEEDS[0])
    assert result["correct"] is True
