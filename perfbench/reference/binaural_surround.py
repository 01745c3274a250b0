"""Plain float64 reference of the binaural chain for surround input: HRIR
convolution, then EQ. A copy of binaural.py that also knows the 7.1 layout
(FL FR FC LFE BL BR SL SR, the order in which 8 captured channels are taken
as 7.1); every speaker of it has a pair of the 14-channel HeSuVi bank, and
LFE is rendered through FC's pair at unit gain with no low-pass, as the
source's map gives it.

It imports nothing of the program. From the raw bank, the EQ definition and
the input that the benchmark hands both sides it works out again what the
program derives at set-up:

  * the channel map: which channel of the 14-channel HeSuVi bank feeds each
    ear of each virtual speaker (the production HeSuVi order, a frozen copy);
  * the RBJ Audio-EQ-Cookbook biquad coefficients of every filter;
  * the convolution.

The EQ is linear and time-invariant once no crossfade is running, so each
ear's output is the sum over speakers of the input convolved with one
response: the speaker's HRIR for that ear, convolved with the cascade's
impulse response times the preamp. The cascade's impulse response is run
sample by sample through the biquads in direct form, in float64, until its
tail is below `TAIL_FRACTION` of its peak; the truncation then changes no
output by more than that fraction. Convolution is by FFT in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Production 14-channel HeSuVi order: L0 L1 SL0 SL1 RL0 RL1 C0 R1 R0 SR1 SR0
# RR1 RR0 C1. Each speaker maps to its (left-ear, right-ear) channels.
HESUVI14 = {
    "FL": (0, 1), "FR": (8, 7), "FC": (6, 13), "LFE": (6, 13),
    "BL": (4, 5), "BR": (12, 11), "SL": (2, 3), "SR": (10, 9),
}
LAYOUTS = {"stereo": ("FL", "FR"),
           "7.1": ("FL", "FR", "FC", "LFE", "BL", "BR", "SL", "SR")}

TAIL_FRACTION = 1e-15
FIRST_IMPULSE_FRAMES = 4096
MAX_IMPULSE_FRAMES = 1 << 20


def speaker_channels(layout: str) -> list:
    """[(left-ear channel, right-ear channel)] per speaker of `layout`."""
    return [HESUVI14[s] for s in LAYOUTS[layout]]


def rbj_biquad(kind: str, frequency_hz: float, gain_db: float, q: float,
               sample_rate: float) -> tuple:
    """(b0, b1, b2, a1, a2), normalised by a0, from the Audio-EQ-Cookbook."""
    a = 10.0 ** (gain_db / 40.0)
    w = 2.0 * math.pi * frequency_hz / sample_rate
    cw, sw = math.cos(w), math.sin(w)
    alpha = sw / (2.0 * q)
    sa = 2.0 * math.sqrt(a) * alpha
    if kind == "peaking":
        b = (1 + alpha * a, -2 * cw, 1 - alpha * a)
        den = (1 + alpha / a, -2 * cw, 1 - alpha / a)
    elif kind == "low_shelf":
        b = (a * ((a + 1) - (a - 1) * cw + sa),
             2 * a * ((a - 1) - (a + 1) * cw),
             a * ((a + 1) - (a - 1) * cw - sa))
        den = ((a + 1) + (a - 1) * cw + sa,
               -2 * ((a - 1) + (a + 1) * cw),
               (a + 1) + (a - 1) * cw - sa)
    elif kind == "high_shelf":
        b = (a * ((a + 1) + (a - 1) * cw + sa),
             -2 * a * ((a - 1) + (a + 1) * cw),
             a * ((a + 1) + (a - 1) * cw - sa))
        den = ((a + 1) - (a - 1) * cw + sa,
               2 * ((a - 1) - (a + 1) * cw),
               (a + 1) - (a - 1) * cw - sa)
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    a0 = den[0]
    return (b[0] / a0, b[1] / a0, b[2] / a0, den[1] / a0, den[2] / a0)


def _run_biquads(biquads: list, x: np.ndarray) -> np.ndarray:
    """x through each biquad in turn, direct form I, sample by sample."""
    y = x
    for b0, b1, b2, a1, a2 in biquads:
        out = np.zeros_like(y)
        x1 = x2 = y1 = y2 = 0.0
        for n, xn in enumerate(y.tolist()):
            yn = b0 * xn + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            out[n] = yn
            x2, x1, y2, y1 = x1, xn, y1, yn
        y = out
    return y


def eq_impulse(eq: dict, sample_rate: float) -> np.ndarray:
    """The EQ's impulse response (preamp included), float64, long enough
    that its last eighth is below TAIL_FRACTION of its peak."""
    biquads = [rbj_biquad(f["type"], f["frequency_hz"], f["gain_db"], f["q"],
                          sample_rate)
               for f in eq["filters"] if f.get("enabled", True)]
    preamp = 10.0 ** (eq["preamp_db"] / 20.0)
    frames = FIRST_IMPULSE_FRAMES
    while True:
        delta = np.zeros(frames)
        delta[0] = preamp
        h = _run_biquads(biquads, delta)
        tail = np.abs(h[-frames // 8:]).max()
        if not biquads or tail <= TAIL_FRACTION * np.abs(h).max():
            return h
        if frames >= MAX_IMPULSE_FRAMES:
            raise ValueError("the EQ's impulse response does not decay")
        frames *= 2


def responses(bank: np.ndarray, layout: str, eq: "dict | None",
              sample_rate: float) -> np.ndarray:
    """[S, 2, L] float64: per speaker and ear, the HRIR from the raw
    [channels, taps] bank, convolved with the EQ's impulse response when
    `eq` is given."""
    bank = np.asarray(bank, np.float64)
    g = np.stack([np.stack([bank[left], bank[right]])
                  for left, right in speaker_channels(layout)])
    if eq is None:
        return g
    h = eq_impulse(eq, sample_rate)
    n = g.shape[-1] + h.shape[0] - 1
    nfft = 1 << (n - 1).bit_length()
    return np.fft.irfft(np.fft.rfft(g, nfft) * np.fft.rfft(h, nfft),
                        nfft)[..., :n]


def render(g: torch.Tensor, x: torch.Tensor, frames: int) -> torch.Tensor:
    """The last `frames` output frames of each segment.

    g [S, E, L] float64 responses; x [N, S, F] float64 input segments whose
    first F - frames samples are the history the outputs need (zeros stand
    for time before the stream began; F - frames >= L - 1).
    Returns y [N, E, frames] float64."""
    L = g.shape[-1]
    F = x.shape[-1]
    if F - frames < L - 1:
        raise ValueError(f"segments of {F} frames hold too little history "
                         f"for {frames} outputs of a {L}-tap response")
    nfft = 1 << (F + L - 2).bit_length()
    gx = torch.fft.rfft(g, nfft)                       # [S, E, K]
    xx = torch.fft.rfft(x, nfft)                       # [N, S, K]
    y = torch.fft.irfft(torch.einsum("nsk,sek->nek", xx, gx), nfft)
    return y[..., F - frames:F]
