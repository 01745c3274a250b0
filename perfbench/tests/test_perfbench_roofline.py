"""The MAC's least work against the bounds the kernel table holds (PERF.md:
0.2239 ms at K=520 R=40 O=4 B=8192, 1.3040 ms for 3 pages of K=520 R=32
O=32 B=16384), the shapes each configuration gives, and the relaxed DFT
products' least work and their reader."""

import pytest

from perfbench.core.cell import Run
from perfbench.core.roofline import (Contraction, RelaxedProduct,
                                     chain_contraction, relaxed_dft_products,
                                     share_pct)
from perfbench.core.spec import Spec
from perfbench.core.trace import DeviceOp, Trace


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
    ("bake_hesuvi_stereo_high", 16384, Contraction(520, 32, 32, 16384, 3)),
])
def test_configuration_shapes(config, lanes, want):
    assert chain_contraction(Spec().config(config), lanes) == want


def test_share_counts_steps_not_launches():
    ops = [DeviceOp("k", 0.0, 100.0, 0, ()), DeviceOp("k", 0.0, 100.0, 0, ()),
           DeviceOp("k", 0.0, 200.0, 1, ())]
    # Two steps of 100 us least time over 400 us of kernels.
    assert share_pct(ops, 100e-6) == pytest.approx(50.0)
    assert share_pct([], 1.0) is None


def test_relaxed_products_of_the_high_bake_by_hand():
    """bake_hesuvi_stereo_high at 16,384 lanes: the analysis [1026, 512] @
    [512, 2*8*16384] and the synthesis [512, 1040] @ [1040, 2*8*16384], as
    three bf16 passes each, bound by FLOPs at these widths."""
    n = 2 * 8 * 16384
    analysis, synthesis = relaxed_dft_products(
        Spec().config("bake_hesuvi_stereo_high"), 16384)
    assert analysis == RelaxedProduct(1026, 512, n, 3)
    assert synthesis == RelaxedProduct(512, 1040, n, 3)
    assert analysis.flops() == 3 * 2 * 1026 * 512 * n == 826_244_333_568
    assert analysis.bytes() == (4 * 512 * n + 4 * 1026 * n
                                + 2 * 1026 * 3 * 512) == 1_615_861_760
    assert synthesis.flops() == 3 * 2 * 512 * 1040 * n == 837_518_622_720
    assert synthesis.bytes() == (4 * 1040 * n + 4 * 512 * n
                                 + 2 * 512 * 3 * 1040) == 1_630_584_832
    for p in (analysis, synthesis):
        assert p.flops() / 989e12 > p.bytes() / 3.35e12
        assert p.least_seconds() == p.flops() / 989e12
    assert round(analysis.least_seconds() * 1e3, 4) == 0.8354
    assert round(synthesis.least_seconds() * 1e3, 4) == 0.8468


def test_no_relaxed_product_at_the_strict_tier():
    for name in ("bake_hesuvi_stereo", "ring_hesuvi_stereo"):
        assert relaxed_dft_products(Spec().config(name), 16384) == []


def _run(config: str, stacked) -> Run:
    return Run(config=Spec().config(config), traffic={}, lanes=16384,
               frames_per_step=4096, blocks_per_step=8, sample_rate=48_000.0,
               setup_s=1.0, window_steps=10, window_s=1.0, round_ms=[],
               dispatch_ns=[], peak_bytes=0, input_bytes=0, on_card=True,
               stacked=stacked)


def _trace(ops) -> Trace:
    return Trace(1000.0, 900.0, ops, 2, len(ops), 0, [], True)


def test_relaxed_reader_reads_nothing_without_stacks_or_records():
    read = Spec().metric_reader("dft_relaxed.roofline_pct").read
    assert read(_run("bake_hesuvi_stereo_high", None)) is None
    assert read(_run("bake_hesuvi_stereo_high", _trace([]))) is None
    # Records without frames: no kernel name tells the products apart.
    assert read(_run("bake_hesuvi_stereo_high",
                     _trace([DeviceOp("gemm", 0.0, 500.0, 0, ())]))) is None
    # At "highest" nothing runs relaxed, whatever the frames say.
    framed = DeviceOp("gemm", 0.0, 500.0, 0, (
        ("ops/precision", "product"), ("ops/precision", "matmul"),
        ("ops/upols", "paged_project")))
    assert read(_run("bake_hesuvi_stereo", _trace([framed]))) is None


def test_relaxed_reader_takes_the_convolution_products_and_their_splits():
    read = Spec().metric_reader("dft_relaxed.roofline_pct").read
    P = ("ops/precision", "matmul")

    def op(step, us, *frames):
        return DeviceOp("k", 0.0, us, step, frames)

    ops = [
        op(0, 1000.0, ("ops/precision", "operand"), P,
           ("ops/upols", "conv_step_paged_raw")),
        op(0, 2000.0, ("ops/precision", "product"), P,
           ("ops/upols", "conv_step_paged_raw")),
        op(1, 3000.0, ("ops/precision", "product"), P,
           ("ops/upols", "paged_project"),
           ("ops/eq_block", "eq_folded_paged_round")),
        # Not the convolution's: the EQ's relaxed product, the layout
        # copies of the analysis, the MAC.
        op(1, 9000.0, ("ops/precision", "product"), P,
           ("ops/eq_block", "eq_apply_folded")),
        op(1, 9000.0, ("ops/upols", "conv_step_paged_raw")),
        op(1, 9000.0, ("kernels/mac_kmajor", "mac_kmajor_pages")),
    ]
    least = sum(p.least_seconds() for p in relaxed_dft_products(
        Spec().config("bake_hesuvi_stereo_high"), 16384))
    # Two steps hold 6 ms of the products and their splits.
    assert read(_run("bake_hesuvi_stereo_high", _trace(ops))) == (
        pytest.approx(100.0 * least * 2 / 6e-3))
