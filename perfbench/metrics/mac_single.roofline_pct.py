"""mac_single.roofline_pct (%, layer: MAC kernels): the single-block MAC's
share of its roofline, mac_kmajor on every route, on the ring tier. Moves
x_realtime.

As mac_pages.roofline_pct, for the kernels launched under kernels/
mac_kmajor's mac_kmajor (its routes small, balanced, tiled and generic);
the kernel-name table where the trace has no frames."""

from perfbench.core.roofline import chain_contraction, share_pct
from perfbench.core.trace import owned_ops

MODULES = ("kernels/mac_kmajor:mac_kmajor",)
KERNEL_NAMES = r"mac_kmajor_(small|tiled|fixed|generic)"


def read(run):
    t = run.stacked
    if t is None or run.blocks_per_step != 1:
        return None
    least = chain_contraction(run.config, run.lanes).least_seconds()
    return share_pct(owned_ops(t, MODULES, (), KERNEL_NAMES), least)
