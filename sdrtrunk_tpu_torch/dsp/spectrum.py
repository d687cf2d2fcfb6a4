"""Spectral analysis: windowed FFT frames and Welch averaging (port of
sdrtrunk_tpu/dsp/spectrum.py; role of spectrum/DFTProcessor.java:48,213,
the data behind the spectral display, as arrays and a JSONL-able
summary). The frames are one batched ``torch.fft.fft`` on the input's
device; the windows are the copied ``dsp/windows.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import windows

__all__ = ["SpectrumConfig", "power_spectrum", "spectrogram",
           "channel_power_map"]


@dataclass(frozen=True)
class SpectrumConfig:
    fft_size: int = 1024
    window: str = "blackman_harris_7"   # DFTProcessor default family
    overlap: float = 0.5
    average_frames: int = 4


def spectrogram(x: torch.Tensor, config: SpectrumConfig = SpectrumConfig()
                ) -> torch.Tensor:
    """Complex IQ (n,) -> (frames, fft_size) power in dB, DC-centered."""
    n = config.fft_size
    hop = max(1, int(n * (1.0 - config.overlap)))
    num = max(0, (x.shape[0] - n) // hop + 1)
    if num == 0:
        return torch.zeros((0, n), dtype=torch.float32, device=x.device)
    window = torch.as_tensor(
        windows.get_window(config.window, n).astype(np.float32),
        device=x.device)
    frames = x.to(torch.complex64).unfold(0, n, hop)[:num] * window
    spec = torch.fft.fftshift(torch.fft.fft(frames, dim=-1), dim=-1)
    power = spec.abs() ** 2 / (n * n)
    return (10.0 * torch.log10(power + 1e-20)).to(torch.float32)


def power_spectrum(x: torch.Tensor,
                   config: SpectrumConfig = SpectrumConfig()) -> torch.Tensor:
    """Welch-averaged power spectrum in dB (fft_size bins, DC centered)."""
    frames = spectrogram(x, config)
    if frames.shape[0] == 0:
        return torch.full((config.fft_size,), -200.0, dtype=torch.float32,
                          device=x.device)
    linear = 10.0 ** (frames / 10.0)
    return (10.0 * torch.log10(linear.mean(dim=0) + 1e-20)
            ).to(torch.float32)


def channel_power_map(x: torch.Tensor, sample_rate: float,
                      channel_bandwidth: float = 12500.0,
                      config: SpectrumConfig = SpectrumConfig()):
    """Per-channel average power: the occupancy view of the band.

    Returns (center_frequencies_hz, power_db) NumPy arrays with one entry
    per channel_bandwidth-wide slot across the captured span.
    """
    spec = power_spectrum(x, config).cpu().numpy()
    n = config.fft_size
    bin_hz = sample_rate / n
    bins_per_channel = max(1, int(round(channel_bandwidth / bin_hz)))
    n_channels = n // bins_per_channel
    usable = n_channels * bins_per_channel
    linear = 10.0 ** (spec[:usable] / 10.0)
    per_channel = linear.reshape(n_channels, bins_per_channel).mean(axis=1)
    power_db = 10.0 * np.log10(per_channel + 1e-20)
    centers = (np.arange(n_channels) + 0.5) * bins_per_channel * bin_hz \
        - sample_rate / 2.0
    return centers, power_db
