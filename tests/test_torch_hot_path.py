"""tools/check_hot_path of the PyTorch port: the tree's step functions and
precision tier helpers are free of host syncs and I/O, and the gate
catches a sync planted in a copy of them."""

import pathlib
import shutil

import pytest

from airwave_tpu_torch.tools import check_hot_path


def test_tree_is_clean():
    assert check_hot_path.run() == []


def _copy_hot_modules(dst: pathlib.Path) -> None:
    for rel in check_hot_path.HOT_MODULES:
        target = dst / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(check_hot_path.ROOT / rel, target)


@pytest.mark.parametrize("rel,anchor,planted,calls", [
    ("airwave_tpu_torch/ops/upols.py", "def _paged_mac(",
     "    _ = pages[0].sum().item()\n", {"item"}),
    ("airwave_tpu_torch/ops/precision.py", "def product(",
     "    torch.cuda.synchronize()\n", {"torch.cuda.synchronize"}),
    ("airwave_tpu_torch/ops/eq_block.py", "def _cascade_block(",
     "    print(x.cpu())\n", {"print", "x.cpu"}),
])
def test_gate_catches_a_planted_sync(tmp_path, rel, anchor, planted, calls):
    """The planted line goes first in the function's body, in a temporary
    copy of the hot modules; the gate names it and nothing else."""
    _copy_hot_modules(tmp_path)
    path = tmp_path / rel
    lines = path.read_text().splitlines(keepends=True)
    start = next(i for i, line in enumerate(lines) if line.startswith(anchor))
    body = next(i for i in range(start, len(lines))
                if lines[i].rstrip().endswith(":")) + 1
    path.write_text("".join(lines[:body] + [planted] + lines[body:]))
    problems = check_hot_path.run(tmp_path)
    assert {(p[0], p[1]) for p in problems} == {(rel, body + 1)}, problems
    assert {p[2] for p in problems} == calls
