"""Polyphase fractional-delay interpolator bank (host-designed, device-used).

Role of the reference's 8-tap / 128-step interpolating filter bank
(dsp/filter/interpolator/RealInterpolator.java:41, Interpolator.java taps
table). We design our own bank — a Blackman-windowed sinc evaluated at each
fractional offset — rather than reusing its table: same structure (8 taps,
128 steps + guard row, interpolation point between taps 3 and 4), numerically
equivalent in-band.
"""
from __future__ import annotations

import numpy as np

__all__ = ["interpolator_bank", "NSTEPS", "NTAPS", "CENTER"]

NSTEPS = 128
NTAPS = 8
CENTER = 3  # interpolated point lies between sample[CENTER] and sample[CENTER+1]


def interpolator_bank(nsteps: int = NSTEPS, ntaps: int = NTAPS) -> np.ndarray:
    """(nsteps+1, ntaps) bank; row i interpolates at mu = i/nsteps.

    bank[i, j] multiplies samples[j]; the interpolated instant is
    CENTER + mu samples into the 8-sample window. Row `nsteps` (mu=1.0)
    equals row 0 shifted, provided as a guard for index==nsteps.
    """
    bank = np.zeros((nsteps + 1, ntaps), dtype=np.float64)
    j = np.arange(ntaps, dtype=np.float64)
    for i in range(nsteps + 1):
        mu = i / nsteps
        t = j - (CENTER + mu)
        h = np.sinc(t)
        # Blackman window centered on the interpolation instant, spanning
        # the 8-tap support
        w = (0.42 + 0.5 * np.cos(np.pi * t / (ntaps / 2.0))
             + 0.08 * np.cos(2.0 * np.pi * t / (ntaps / 2.0)))
        w = np.where(np.abs(t) <= ntaps / 2.0, w, 0.0)
        taps = h * w
        bank[i] = taps / np.sum(taps)  # unit DC gain per row
    return bank.astype(np.float32)
