"""The offline converter's fractional-delay kernel.

Port of `fractional_delay_kernel` and `FRACTIONAL_DELAY_TAPS` of
airwave_tpu/tools/convert.py, the same numpy code: the bundled HRIR
synthesis (assets/bundled.py) renders its interaural delays with it, so a
bank synthesised by either package is the same array bit for bit. The rest
of the SOFA -> HeSuVi converter (SOFA reading, direction selection, delay
materialisation, loudness matching, the WAV and manifest writer) is not
ported yet (ROADMAP Queue 1 item 21).

The numeric contract is the reference tool's
(tools/ss2-to-hesuvi/convert.py:386-428): fractional source delays are
rendered with a 65-tap Blackman-windowed sinc, normalised to unit DC gain.
"""

from __future__ import annotations

import numpy as np

FRACTIONAL_DELAY_TAPS = 65


def fractional_delay_kernel(fraction: float,
                            taps: int = FRACTIONAL_DELAY_TAPS) -> np.ndarray:
    if taps < 3 or taps % 2 == 0:
        raise ValueError(f"tap count {taps} must be odd and >= 3")
    half = taps // 2
    offsets = np.arange(-half, half + 1, dtype=np.float64)
    kernel = np.sinc(offsets - fraction) * np.blackman(taps)
    return kernel / np.sum(kernel)
