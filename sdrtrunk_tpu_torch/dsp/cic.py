"""Prime-factor CIC decimation and heterodyne DDC, the path beside the
channelizer (port of sdrtrunk_tpu/dsp/cic.py).

The reference's alternate channel source
(source/tuner/channel/CICTunerChannelSource.java:39,
dsp/filter/cic/ComplexPrimeCICDecimate.java:49): oscillator mix to
baseband, a cascade of order-1 prime-factor CIC (boxcar-average)
decimating stages, then a Remez low-pass cleanup filter. Each stage of
factor p is a length-p moving average decimated by p: on a dense block, a
reshape and a mean over the new axis, with no integrator or comb state.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from . import design
from .fir import fir_apply
from .oscillator import mix_down

__all__ = ["prime_factors", "cic_decimate", "CICChannel"]


def prime_factors(decimation: int) -> list[int]:
    """Prime-factor stage sizes, largest first (ComplexPrimeCICDecimate
    getPrimeFactors delegates to commons-math Primes.primeFactors, which is
    unbounded — so factor by trial division, no fixed table)."""
    if decimation < 1:
        raise ValueError("decimation must be >= 1")
    factors = []
    rem = decimation
    p = 2
    while p * p <= rem:
        while rem % p == 0:
            factors.append(p)
            rem //= p
        p += 1 if p == 2 else 2
    if rem > 1:
        factors.append(rem)
    return sorted(factors, reverse=True)


def cic_decimate(x: torch.Tensor, decimation: int) -> torch.Tensor:
    """Cascaded order-1 prime-factor CIC decimation of a dense block.

    x: (..., N) with N % decimation == 0. Each stage p averages groups of p
    samples. Passband droop is cleaned up downstream (CICChannel).
    """
    n = x.shape[-1]
    if n % decimation:
        raise ValueError(f"block length {n} not divisible by {decimation}")
    for p in prime_factors(decimation):
        x = x.reshape(*x.shape[:-1], x.shape[-1] // p, p).mean(dim=-1)
    return x


@dataclass
class CICChannel:
    """Heterodyne DDC: mix to baseband -> prime CIC decimate -> cleanup FIR.

    The per-channel alternative to the polyphase channelizer for one-off
    channels (CICTunerChannelSource.java:39). Streaming state carries the
    oscillator phase and the cleanup FIR's history, on ``device``.
    """
    sample_rate: float
    frequency_offset: float
    decimation: int
    cleanup_taps: np.ndarray = field(repr=False, default=None)
    device: str = "cuda"

    @classmethod
    def design(cls, sample_rate: float, frequency_offset: float,
               channel_rate: float, pass_hz: float | None = None,
               stop_hz: float | None = None, device="cuda") -> "CICChannel":
        decimation = int(round(sample_rate / channel_rate))
        out_rate = sample_rate / decimation
        if pass_hz is None:
            pass_hz = out_rate / 4.0   # reference example: 1/4 channel rate
        if stop_hz is None:
            stop_hz = out_rate * 0.45
        taps = design.remez_lowpass(63, pass_hz, stop_hz, out_rate)
        return cls(sample_rate=sample_rate, frequency_offset=frequency_offset,
                   decimation=decimation, cleanup_taps=taps, device=device)

    @property
    def output_rate(self) -> float:
        return self.sample_rate / self.decimation

    def init_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        dev = resolve_device(self.device)
        return (torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((len(self.cleanup_taps) - 1,),
                            dtype=torch.complex64, device=dev))

    def __call__(self, x: torch.Tensor, state=None):
        """x: (N,) complex64 wideband, N % decimation == 0.
        Returns (baseband channel at output_rate, new state)."""
        if state is None:
            state = self.init_state()
        phase, fir_hist = state
        mixed, phase = mix_down(x, self.frequency_offset, self.sample_rate,
                                phase)
        dec = cic_decimate(mixed, self.decimation)
        taps = torch.as_tensor(np.asarray(self.cleanup_taps, np.float32),
                               device=x.device)
        y, fir_hist = fir_apply(dec[None], taps, fir_hist[None])
        return y[0], (phase, fir_hist[0])
