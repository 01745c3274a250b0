"""dft_relaxed.roofline_pct (%, layer: convolution ops at a relaxed tier):
the relaxed analysis and synthesis DFT products' share of their roofline,
their activations' bf16 splits counted with them. Moves x_realtime.

The two products' least time a step (perfbench/core/roofline.py
relaxed_dft_products: the tier's bf16 passes against 989 TFLOP/s, the fp32
activation read once, the fp32 output written once and the bf16 weight
operand read once against 3.35 TB/s) over the device time a step of the
kernels whose innermost program frame lies in ops/precision (operand or
product) and whose first frame outside it lies in the convolution ops
(ops/upols, ops/fftmm), over the traced steps that hold a record of them.
Without stacks no kernel name tells these products from the EQ's, and at
"highest" no relaxed product runs: the reader reads nothing then."""

from perfbench.core.roofline import relaxed_dft_products, share_pct

PRECISION = "ops/precision"
CALLERS = ("ops/upols", "ops/fftmm")


def _caller(frames):
    return next((module for module, _ in frames if module != PRECISION), None)


def read(run):
    t = run.stacked
    products = relaxed_dft_products(run.config, run.lanes)
    if t is None or not products:
        return None
    ops = [op for op in t.ops if op.frames and op.frames[0][0] == PRECISION
           and _caller(op.frames) in CALLERS]
    return share_pct(ops, sum(p.least_seconds() for p in products))
