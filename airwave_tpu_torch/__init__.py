"""airwave_tpu_torch — the PyTorch/CUDA port of airwave_tpu.

The batched binaural render chain (half-window uniform partitioned
overlap-save HRIR convolution, block state-space EQ) and its offline bake,
written for PyTorch with hand-written CUDA kernels for Hopper (sm_90a). The
module layout mirrors airwave_tpu/ (ops/upols.py, ops/eq_block.py,
models/bake.py, ...) so each port module sits beside its reference.

The port imports no jax; from airwave_tpu it uses only the jax-free modules
(config, utils.errors, io.apo, io.wav, oracle.upols_oracle,
assets.channel_maps).
"""

__version__ = "0.1.0"

from airwave_tpu_torch.device import apply_precision_policy, resolve_device

__all__ = ["__version__", "apply_precision_policy", "resolve_device"]
