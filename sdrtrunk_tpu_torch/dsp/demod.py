"""Demodulators and squelch (port of sdrtrunk_tpu/dsp/demod.py:19-78).

Batched over channels: x is (C, T) complex and every carried state has a
leading C axis. FM is the conjugate-product phase discriminator, AM the
envelope detector, and the squelch a one-pole power monitor with a
threshold gate.
"""
from __future__ import annotations

import math

import torch

from . import iir

__all__ = ["fm_demodulate", "fm_gain", "am_demodulate", "power_db",
           "power_squelch", "SquelchResult"]


def fm_gain(sample_rate: float, deviation_hz: float) -> float:
    """Gain that maps +/-deviation_hz instantaneous frequency to +/-1.0."""
    return sample_rate / (2.0 * math.pi * deviation_hz)


def fm_demodulate(x: torch.Tensor, prev: torch.Tensor | None = None,
                  gain: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Quadrature FM discriminator over (C, T) complex x:
    atan2 of x[n] * conj(x[n-1]), times ``gain``, with x[-1] = ``prev``
    (C,); None takes each row's first sample, as the reference does.
    Returns (float32 (C, T), the last sample of each row (C,))."""
    if prev is None:
        prev = x[:, 0]
    xm1 = torch.cat([prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)
    prod = x * torch.conj(xm1)
    y = torch.atan2(prod.imag, prod.real) * gain
    return y.to(torch.float32), x[:, -1]


def am_demodulate(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Envelope detector over (C, T) complex x."""
    return (torch.abs(x) * gain).to(torch.float32)


def power_db(x: torch.Tensor, alpha: float = 0.0004, state=0.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Smoothed channel power in dB over (C, T) complex x: one-pole IIR
    over |x|^2 (alpha 0.0004, the reference NBFM squelch's). ``state`` is
    the previous smoothed power, (C,) or one value for every channel."""
    p = x.real * x.real + x.imag * x.imag
    smoothed, new_state = iir.single_pole_apply(p, alpha, state)
    return 10.0 * torch.log10(torch.clamp_min(smoothed, 1e-20)), new_state


class SquelchResult(dict):
    """Lightweight result record: keys gate (bool per sample), power_db,
    state (the reference's, dsp/demod.py:60)."""


def power_squelch(x: torch.Tensor, threshold_db: float = -78.0,
                  alpha: float = 0.0004, state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power squelch: per-sample open/closed gate from the smoothed power
    (defaults -78 dB and alpha 0.0004, the reference NBFM squelch's).
    Returns (gate bool (C, T), power_db (C, T), new power state (C,))."""
    if state is None:
        state = torch.zeros(x.shape[:1], dtype=torch.float32,
                            device=x.device)
    pdb, new_state = power_db(x, alpha, state)
    return pdb > threshold_db, pdb, new_state
