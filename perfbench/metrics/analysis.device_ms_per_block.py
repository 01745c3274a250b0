"""analysis.device_ms_per_block (ms/block, layer: convolution ops, analysis):
device time a block of the single-block analysis: fftmm.rfft_mm's product
over every speaker, _to_slot's pad and permute, and the slot write. The
part of a ring round that grows with the speakers, which
dft.device_ms_per_block sums with the synthesis. Moves x_realtime.

An op belongs to it where a frame of ops/upols' conv_step is open around
its launch and no frame of ops/upols' _mac_irfft or of kernels/mac_kmajor
is (ops/precision, which passes the product on from its caller, changes
nothing): the ops that the program's span airwave.conv.analysis holds.
Nothing on the paged tier, whose analysis is conv_step_paged_raw's, and
nothing without stacks, where no kernel name tells the analysis product
from the synthesis's."""

STEP = ("ops/upols", "conv_step")
SYNTHESIS = ("ops/upols", "_mac_irfft")
MAC = "kernels/mac_kmajor"


def owned(op) -> bool:
    return (STEP in op.frames and SYNTHESIS not in op.frames
            and all(module != MAC for module, _ in op.frames))


def read(run):
    t = run.stacked
    if t is None or not t.steps or run.blocks_per_step != 1:
        return None
    ops = [op for op in t.ops if owned(op)]
    if not ops:
        return None
    return sum(op.dur_us for op in ops) / 1e3 / t.steps
