"""The MAC's least work against the bounds the kernel table holds (PERF.md:
0.2239 ms at K=520 R=40 O=4 B=8192, 1.3040 ms for 3 pages of K=520 R=32
O=32 B=16384), and the shapes each configuration gives."""

import pytest

from perfbench.core.roofline import (Contraction, chain_contraction,
                                     share_pct)
from perfbench.core.spec import Spec
from perfbench.core.trace import DeviceOp


def test_single_block_bound():
    c = Contraction(520, 40, 4, 8192, 1)
    assert c.bytes() == 4 * (520 * 40 * 8192 + 520 * 4 * 40 + 4 * 520 * 8192)
    assert c.flops() == 2 * 520 * 40 * 4 * 8192
    assert round(c.least_seconds() * 1e3, 4) == 0.2239


def test_paged_bound():
    c = Contraction(520, 32, 32, 16384, 3)
    assert round(c.least_seconds() * 1e3, 4) == 1.3040
    # Bound by bytes, not by FLOPs, at these widths.
    assert c.bytes() / 3.35e12 > c.flops() / 67e12


@pytest.mark.parametrize("config, lanes, want", [
    ("bake_hesuvi_stereo", 16384, Contraction(520, 32, 32, 16384, 3)),
    ("ring_hesuvi_stereo", 8192, Contraction(520, 40, 4, 8192, 1)),
    ("ring_hesuvi_stereo", 32768, Contraction(520, 40, 4, 32768, 1)),
])
def test_configuration_shapes(config, lanes, want):
    assert chain_contraction(Spec().config(config), lanes) == want


def test_share_counts_steps_not_launches():
    ops = [DeviceOp("k", 0.0, 100.0, 0, ()), DeviceOp("k", 0.0, 100.0, 0, ()),
           DeviceOp("k", 0.0, 200.0, 1, ())]
    # Two steps of 100 us least time over 400 us of kernels.
    assert share_pct(ops, 100e-6) == pytest.approx(50.0)
    assert share_pct([], 1.0) is None
