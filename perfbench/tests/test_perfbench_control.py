"""The control of the comparison, on the card at each cell's own size: the
program at the precision tier one step below its configuration's
(AIRWAVE_MATMUL_PRECISION: bf16x3 on the tensor cores, "high", below strict
fp32, "highest"; one bf16 pass, "default", below bf16x3) in the program's
place, on three seeds, must come out not correct; the configuration's own
tier must come out correct. Each run is a whole run of the command, at the
benchmark's run_seconds.

    python -m pytest perfbench/tests -m cuda -q
"""

import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT
from perfbench.core.spec import Spec

SEEDS = [2147483659, 2400000017, 3000000019]
LOWER = {"highest": "high", "high": "default"}


def lower_tier(cell: str) -> str:
    """The tier one step below that of the cell's configuration."""
    spec = Spec()
    return LOWER[spec.config(spec.cell(cell)["config"])["tier"]]


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
    result = run(cell, seed, "--tier", lower_tier(cell))
    assert result["correct"] is False
    check = result["checks"]["worst_rel_rms"]
    assert check["value"] > check["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_configuration_tier_is_correct(cuda_card, cell):
    result = run(cell, SEEDS[0])
    assert result["correct"] is True
