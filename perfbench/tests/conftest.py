"""Shared fixtures of the benchmark's tests: the repository on sys.path, a
card fixture for the tests that need one, and a tiny copy of the benchmark
that the CPU runs through the whole harness."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The tiny copy's sizes: every width of the configuration kept but the
# block and the bank's length, which set how much the CPU computes.
TINY_CONFIG = {"block_size": 32, "hrir_taps": 100}
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
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **TINY_CONFIG)))
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
