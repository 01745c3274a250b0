"""dft.device_ms_per_block (ms/block, layer: convolution ops): device time a
block of the kernels that the convolution ops launch: the analysis and
synthesis DFT products and the copies, pads and adds around them. Moves
x_realtime.

Each kernel goes to the program module whose frame was innermost around its
launch in the trace recorded with Python stacks. ops/precision only passes a
product on from its caller, so a kernel under it goes to the caller's layer.
Without stacks no kernel name tells the DFT products from the EQ's, and
the reader reads nothing."""

from perfbench.core.trace import owned_ops

MODULES = ("ops/upols", "ops/fftmm")
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
