"""airwave_tpu_torch — the PyTorch/CUDA port of airwave_tpu.

The batched binaural render chain (half-window uniform partitioned
overlap-save HRIR convolution, block state-space EQ), its offline bake and
the serving pool, written for PyTorch with hand-written CUDA kernels for
Hopper (sm_90a). The module layout mirrors airwave_tpu/ (ops/upols.py,
ops/eq_block.py, models/bake.py, runtime/stream_pool.py, ...) so each port
module sits beside its reference.

The port imports no jax and no module of airwave_tpu: it keeps its own
copies of the host modules it needs (config, utils.errors, io.apo, io.wav,
assets.channel_maps). Entry points and builders run on the card unless the
caller passes device="cpu".
"""

__version__ = "0.1.0"

from airwave_tpu_torch.device import apply_precision_policy, resolve_device

__all__ = ["__version__", "apply_precision_policy", "resolve_device"]
