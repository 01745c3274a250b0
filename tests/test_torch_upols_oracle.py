"""oracle/upols_oracle of the PyTorch port against the JAX package's
float64 conv oracle it copies: equal bit for bit on seeded inputs."""

import numpy as np
import pytest

from airwave_tpu.oracle import upols_oracle as joracle
from airwave_tpu_torch.oracle import upols_oracle as toracle


@pytest.mark.parametrize("length,block,n_blocks", [
    (4320, 512, 12),   # the bundled HRIR's length at the production block
    (300, 64, 9),      # a partial last partition
    (40, 64, 3),       # shorter than one block
    (128, 64, 5),      # whole partitions
])
def test_process_matches_jax_bit_for_bit(length, block, n_blocks):
    rng = np.random.default_rng(length + block)
    hrir = rng.standard_normal(length) * 0.3
    x = rng.standard_normal((n_blocks, block)).astype(np.float32)
    mine, theirs = toracle.UPOLSOracle(hrir, block), joracle.UPOLSOracle(hrir, block)
    assert mine.partition_count == theirs.partition_count
    assert np.array_equal(mine.H, theirs.H)
    for blk in x:
        assert np.array_equal(mine.process(blk), theirs.process(blk))
    mine.reset()
    theirs.reset()
    for blk in x[::-1]:
        assert np.array_equal(mine.process_f32(blk), theirs.process_f32(blk))


def test_matches_direct_convolution():
    """The copy, like the original, is the linear convolution to 1e-12."""
    rng = np.random.default_rng(11)
    hrir, block = rng.standard_normal(1000), 128
    x = rng.standard_normal(12 * block)
    oracle = toracle.UPOLSOracle(hrir, block)
    got = np.concatenate([oracle.process(x[i:i + block])
                          for i in range(0, x.size, block)])
    want = np.convolve(x, hrir)[:x.size]
    assert np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)) < 1e-12


@pytest.mark.parametrize("bad", [np.zeros(0), np.zeros((2, 3))])
def test_rejects_what_the_jax_oracle_rejects(bad):
    for module in (toracle, joracle):
        with pytest.raises(ValueError):
            module.UPOLSOracle(bad, 64)
