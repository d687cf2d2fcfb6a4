"""Channel power monitor (port of sdrtrunk_tpu/dsp/demod.py:48-57)."""
from __future__ import annotations

import torch

from . import iir

__all__ = ["power_db"]


def power_db(x: torch.Tensor, alpha: float, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Smoothed channel power in dB over (C, T) complex x: one-pole IIR
    over |x|^2. ``state`` (C,) is the previous smoothed power."""
    p = x.real * x.real + x.imag * x.imag
    smoothed, new_state = iir.single_pole_apply(p, alpha, state)
    return 10.0 * torch.log10(torch.clamp_min(smoothed, 1e-20)), new_state
