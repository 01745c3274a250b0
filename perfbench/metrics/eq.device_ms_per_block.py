"""eq.device_ms_per_block (ms/block, layer: EQ ops): device time a block of
the kernels that ops/eq_block launches: eq_step's cascade products on the
single-block tier, and on the paged tier the state recurrence that is left
once the EQ's FIR and state drive are folded into the synthesis. Moves
x_realtime.

Attribution as in dft.device_ms_per_block: the innermost program frame
around the launch, with ops/precision passed through to its caller."""

from perfbench.core.trace import owned_ops

MODULES = ("ops/eq_block",)
THROUGH = ("ops/precision",)
KERNEL_NAMES = None


def read(run):
    t = run.stacked
    if t is None or not t.steps:
        return None
    ops = owned_ops(t, MODULES, THROUGH, KERNEL_NAMES)
    if not ops:
        return None
    return sum(op.dur_us for op in ops) / 1e3 / (t.steps * run.blocks_per_step)
