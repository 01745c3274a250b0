"""The comparison that decides `correct` fails when the timed path is
broken underneath: a full run of each cell's harness on the CPU at the
tiny sizes (the look for a card skipped), with one fault planted in the
step the window drives, for each fault these cells can have. A cell on one
chip has no exchange between chips to leave out."""

import pytest

from conftest import CELLS, TINY_CONFIG, run_tiny


def stale_state(step, entry):
    """The step returns its state unchanged: the carry never advances."""
    def broken(x):
        before = entry.state
        y = step(x)
        entry.state = before
        return y
    return broken


def half_batch(step, entry):
    """Half of the lanes left out: their output rows never written."""
    def broken(x):
        y = step(x).clone()
        y[y.shape[0] // 2:] = 0
        return y
    return broken


def altered_answer(step, entry):
    """An answer altered where it is produced: one sample of every block
    moved by 1e-3 at the tiny copy's block, by as much more at a longer
    block as keeps the same share of the block's energy."""
    def broken(x):
        y = step(x).clone()
        y[..., 5] += 1e-3 * (y.shape[-1] / TINY_CONFIG["block_size"]) ** 0.5
        return y
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale_state, half_batch, altered_answer])
def test_fault_is_not_correct(tiny_spec, cell, fault):
    result, checks = run_tiny(tiny_spec, cell, 2**31 + 21, 0.1, False,
                              fault=f"{__name__}:{fault.__name__}")
    assert result["correct"] is False
    assert result["failed"] > 0
    worst = checks[0]
    assert worst.value > 10 * worst.limit


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_is_correct(tiny_spec, cell):
    result, _ = run_tiny(tiny_spec, cell, 2**31 + 21, 0.1, False)
    assert result["correct"] is True and result["failed"] == 0
