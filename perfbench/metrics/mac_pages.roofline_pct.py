"""mac_pages.roofline_pct (%, layer: MAC kernels): the paged MAC's share of
its roofline, mac_kmajor_pages on the bake tier. Moves x_realtime.

The contraction's least time a step (perfbench/core/roofline.py: every
input byte read once, every output byte written once, against 3.35 TB/s
and 67 TFLOP/s) over the device time a step of the kernels launched under
kernels/mac_kmajor's mac_kmajor_pages, over the traced steps that hold a
record of them. Where the trace has no frames the kernel-name table finds
them."""

from perfbench.core.roofline import chain_contraction, share_pct
from perfbench.core.trace import owned_ops

MODULES = ("kernels/mac_kmajor:mac_kmajor_pages",)
KERNEL_NAMES = r"mac_kmajor_pages"


def read(run):
    t = run.stacked
    if t is None or run.blocks_per_step == 1:
        return None
    least = chain_contraction(run.config, run.lanes).least_seconds()
    return share_pct(owned_ops(t, MODULES, (), KERNEL_NAMES), least)
