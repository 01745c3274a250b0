"""Static hot-path gate: no host synchronisation or I/O in the step
functions.

Port of scripts/check_hot_path.py to the PyTorch port. A step function
that reads a tensor back to the host (.item(), .tolist(), .cpu(),
.numpy(), np.asarray), waits for the card (torch.cuda.synchronize or any
.synchronize()), prints, logs or touches a file stalls the pump thread
once per round, and it is also what CUDA-graph capture cannot record.
This gate parses the modules below and fails if a listed function's body
contains such a call. It reads the source alone: nothing is imported.

    python -m airwave_tpu_torch.tools.check_hot_path   (exit 1 on violation)
"""

from __future__ import annotations

import ast
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

# The compute-path modules and the step functions (and the precision tier
# helpers they run) whose bodies must stay free of host syncs and I/O.
HOT_MODULES = {
    "airwave_tpu_torch/ops/upols.py": {"conv_step", "conv_step_paged_raw",
                                       "_paged_mac", "paged_project",
                                       "_mac_irfft"},
    "airwave_tpu_torch/ops/eq_block.py": {"eq_step", "_cascade_block",
                                          "eq_apply_folded", "_mm",
                                          "_mm_left", "_lanes_last"},
    "airwave_tpu_torch/ops/fftmm.py": {"rfft_mm", "irfft_mm"},
    "airwave_tpu_torch/ops/precision.py": {"operand", "product", "matmul"},
    "airwave_tpu_torch/models/binaural.py": {"chain_step_fn",
                                             "chain_step_multi_fn"},
    "airwave_tpu_torch/runtime/stream_pool.py": {"pool_step_body"},
}

FORBIDDEN_CALLS = {
    "print", "open", "input", "exec", "eval", "breakpoint",
    "item", "tolist", "cpu", "numpy", "asarray", "synchronize",
}
FORBIDDEN_ATTR_PATHS = {"time.time", "time.perf_counter", "time.sleep",
                        "np.random"}
FORBIDDEN_MODULE_ROOTS = {"logging", "os", "sys", "io", "subprocess",
                          "shutil", "pickle", "socket"}


def _attr_path(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def check_function(fn: ast.AST, filename: str) -> list:
    """(file, line, call) for each forbidden call in fn's body."""
    problems = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        path = _attr_path(node.func)
        if not path:
            continue
        if (path.split(".")[-1] in FORBIDDEN_CALLS
                or path in FORBIDDEN_ATTR_PATHS
                or path.split(".")[0] in FORBIDDEN_MODULE_ROOTS):
            problems.append((filename, node.lineno, path))
    return problems


def run(root: "pathlib.Path | str" = ROOT) -> list:
    """Every violation under `root` (a checkout, or a copy of its hot
    modules), and any listed function that is missing."""
    problems = []
    for rel_path, function_names in HOT_MODULES.items():
        tree = ast.parse((pathlib.Path(root) / rel_path).read_text("utf-8"),
                         filename=rel_path)
        found = set()
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in function_names):
                found.add(node.name)
                problems.extend(check_function(node, rel_path))
        missing = function_names - found
        if missing:
            problems.append((rel_path, 0,
                             f"missing hot functions: {sorted(missing)}"))
    return problems


def main() -> int:
    problems = run()
    for filename, line, what in problems:
        print(f"HOT-PATH VIOLATION {filename}:{line}: {what}")
    if not problems:
        print("hot path clean: no host sync or I/O in the step functions")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
