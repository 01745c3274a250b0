"""Shared fixtures of the benchmark's tests: the repository on sys.path, a
card fixture for the tests that need one, a tiny copy of the benchmark
that the CPU runs through the whole harness, the cells of BENCHMARK.json,
and runs of the program at a configuration's precision tier."""

import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TESTS = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.core.cli import TIER_VARS  # noqa: E402

# Every cell of BENCHMARK.json, in its order: the tests that run cells run
# each, those a later change adds too.
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

# The tiny copy's sizes: every width of the configuration kept but the
# block and the bank's length, which set how much the CPU computes. A
# configuration at a relaxed tier keeps its block: the EQ's block
# state-space form carries the bf16x3 products' error from block to block
# through A^T, which at short blocks leaves the relaxed contract (the
# bake's tiny copy on the CPU: 1.5e-4 rel-RMS at 32 frames, 5.6e-5 at 128,
# 6.3e-6 at 512; 4.9e-6 at 32 frames with the EQ off).
TINY_CONFIG = {"block_size": 32, "hrir_taps": 100}
TINY_RELAXED_CONFIG = {"hrir_taps": 600}
TINY_TRAFFIC = {"lanes": 8, "warmup_steps": 2, "trace_steps": 3,
                "steps_per_call": 2}
TINY_CHECK = {"lanes": 4, "steps": 2, "within_steps": 4}


@pytest.fixture
def cuda_card():
    """Skips the test where no CUDA card is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with -m cuda")
    return torch.device("cuda:0")


def make_tiny(root: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's folder under `root`, at
    the tiny sizes above. Returns the copy's benchmark folder."""
    bench = root / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        config = json.loads(path.read_text())
        tiny = TINY_CONFIG if config["tier"] == "highest" else (
            TINY_RELAXED_CONFIG)
        path.write_text(json.dumps(dict(config, **tiny)))
    for w in spec["workloads"]:
        path = bench / "traffic" / f"{w['traffic']}.json"
        t = dict(json.loads(path.read_text()), **TINY_TRAFFIC)
        t["check"] = dict(t["check"], **TINY_CHECK)
        path.write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory):
    """The tiny copy as a Spec."""
    from perfbench.core.spec import Spec

    root = tmp_path_factory.mktemp("tiny")
    return Spec(root, make_tiny(root))


def process_tier() -> "str | None":
    """The tier the program runs at in this process, as cli.set_tier leaves
    the environment (the program reads it when it is imported): None where
    a variable of one kind of product overrides it."""
    if any(os.environ.get(v) for v in TIER_VARS[1:]):
        return None
    return os.environ.get(TIER_VARS[0], "highest").lower()


def at_tier(tier: str, target: str, *args):
    """target(*args), where target is "module:function" of this folder and
    args and the result are JSON, with the program at precision tier
    `tier`: in this process where that is its tier, else in a fresh one
    whose tier is set as the command line sets it, before the program is
    imported."""
    if process_tier() == tier:
        module, function = target.split(":")
        result = getattr(importlib.import_module(module), function)(*args)
        return json.loads(json.dumps(result))
    code = "\n".join([
        "import json, sys",
        f"sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]",
        "from perfbench.core.cli import set_tier",
        f"set_tier({tier!r})",
        "from conftest import at_tier",
        f"print(json.dumps(at_tier({tier!r}, {target!r}, "
        "*json.loads(sys.argv[1]))))"])
    out = subprocess.run([sys.executable, "-c", code, json.dumps(args)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def run_cell_json(root: str, bench: str, cell: str, seed: int,
                  seconds: float, trace: bool,
                  fault: "str | None" = None) -> dict:
    """run_cell on the CPU on the tiny copy at `root`, with `fault`
    ("module:function" of this folder) planted in its step; the result and
    the checks as JSON."""
    from perfbench.core.cell import run_cell
    from perfbench.core.spec import Spec

    if fault is not None:
        module, function = fault.split(":")
        fault = getattr(importlib.import_module(module), function)
    result, checks = run_cell(Spec(Path(root), Path(bench)), cell, seed,
                              seconds, trace, "cpu", fault=fault)
    return {"result": result,
            "checks": [[c.name, c.value, c.limit] for c in checks]}


def run_tiny(spec, cell: str, seed: int, seconds: float, trace: bool,
             fault: "str | None" = None) -> tuple:
    """run_cell(spec, cell, ...) on the CPU with the program at the tier of
    the cell's configuration, as the command line runs a cell: (result,
    checks)."""
    from perfbench.core.cell import Check

    tier = spec.config(spec.cell(cell)["config"])["tier"]
    out = at_tier(tier, "conftest:run_cell_json", str(spec.root),
                  str(spec.bench_dir), cell, seed, seconds, trace, fault)
    return out["result"], [Check(*c) for c in out["checks"]]
