"""Oscillators and mixers (port of sdrtrunk_tpu/dsp/oscillator.py).

The reference's recursive complex oscillator (dsp/mixer/Oscillator.java:21)
becomes direct synthesis e^{2 pi i f t} with a carried phase, so chunked
streaming is phase-continuous and the phase never drifts: it is reduced
mod 2 pi each block instead of accumulating rotation error.
"""
from __future__ import annotations

import math

import torch

from .. import resolve_device
from .synthesizer import rot4

__all__ = ["oscillate", "mix_down", "mix_up", "fs4_down_convert"]

TWO_PI = 2.0 * math.pi


def oscillate(frequency: float, sample_rate: float, num_samples: int,
              phase=0.0, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Complex tone e^{i(2 pi f/fs n + phase)}, n < num_samples, on
    ``device``; returns (samples complex64, next phase float32 0-d)."""
    dev = resolve_device(device)
    step = TWO_PI * frequency / sample_rate
    phase = torch.as_tensor(phase, dtype=torch.float32, device=dev)
    angles = phase + step * torch.arange(num_samples, dtype=torch.float32,
                                         device=dev)
    samples = torch.complex(torch.cos(angles), torch.sin(angles))
    return samples, torch.remainder(phase + step * num_samples, TWO_PI)


def mix_down(x: torch.Tensor, frequency: float, sample_rate: float,
             phase=0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Translate `frequency` to DC: x * e^{-i 2 pi f/fs n} over x's last
    axis."""
    osc, next_phase = oscillate(frequency, sample_rate, x.shape[-1], phase,
                                x.device)
    return x * torch.conj(osc), next_phase


def mix_up(x: torch.Tensor, frequency: float, sample_rate: float,
           phase=0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Translate DC to `frequency`: x * e^{+i 2 pi f/fs n}."""
    osc, next_phase = oscillate(frequency, sample_rate, x.shape[-1], phase,
                                x.device)
    return x * osc, next_phase


def fs4_down_convert(x: torch.Tensor) -> torch.Tensor:
    """Multiply by e^{-i pi n / 2} = cycle (1, -i, -1, i): an fs/4
    down-shift without multiplies (dsp/mixer/FS4DownConverter.java)."""
    n = x.shape[-1]
    return x * rot4(x.device)[torch.arange(n, device=x.device) % 4]
