"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, entry point,
metric or reference sits in a file of its own under the benchmark's folder,
so that a later change adds a cell, a configuration, an entry or a metric as
new files and new entries of BENCHMARK.json, without editing a file that is
already there:

    configs/<config>.json      named by BENCHMARK.json's "file"
    traffic/<traffic>.json     one traffic mix: its entry and its parameters
    entries/<entry>.py         the system under test, driven by the traffic
    metrics/<metric>.py        one reader per metric, end to end or per layer
    reference/<reference>.py   a configuration's plain reference
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """BENCHMARK.json names something that has no file, or a bad value."""


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise SpecError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """BENCHMARK.json at `root`, and the files of its benchmark folder
    `bench_dir` (by default this file's own)."""

    def __init__(self, root: Path = ROOT, bench_dir: "Path | None" = None):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir) if bench_dir else BENCH_DIR
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.metrics = {m["name"]: dict(m, kind=kind)
                        for kind in ("end_to_end", "per_layer")
                        for m in self.data[kind]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                            f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = self.configs.get(name)
        if entry is None:
            raise SpecError(f"no configuration {name!r} in BENCHMARK.json")
        path = self.root / entry["file"]
        if not path.is_file():
            raise SpecError(f"configuration {name!r}: {path} not found")
        return json.loads(path.read_text())

    def traffic(self, name: str) -> dict:
        path = self.bench_dir / "traffic" / f"{name}.json"
        if not path.is_file():
            raise SpecError(f"traffic {name!r}: {path} not found")
        return json.loads(path.read_text())

    def entry(self, name: str):
        return _load_module(self.bench_dir / "entries" / f"{name}.py",
                            f"perfbench_entry_{name}")

    def reference(self, name: str):
        return _load_module(self.bench_dir / "reference" / f"{name}.py",
                            f"perfbench_reference_{name}")

    def metric_reader(self, name: str):
        return _load_module(self.bench_dir / "metrics" / f"{name}.py",
                            "perfbench_metric_" + name.replace(".", "_"))

    def cell_metrics(self, cell: str, kind: str) -> list:
        """The metrics of `kind` ("end_to_end" or "per_layer") that `cell`
        reports: those without a "workloads" key and those that list it."""
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]
