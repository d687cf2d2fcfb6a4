"""Channel extraction from channelizer output (port of
sdrtrunk_tpu/dsp/extract.py: ``ChannelPlan``, ``plan_channels``,
``extract_channels``).

Take the (blocks, M) channelizer result, select the bin (or, for a
channel wider than one bin, the adjacent pair joined by the two-bin
synthesizer) serving each requested channel, mix out the residual offset
and apply gain, batched over all requested channels at once. The plan is
host-side NumPy; the extraction is one gather, one select and one mix on
the channelizer output's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .channelizer import Channelizer
from .synthesizer import rot4

__all__ = ["ChannelPlan", "plan_channels", "extract_channels"]

TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class ChannelPlan:
    """Static plan mapping requested channels onto channelizer bins.

    bins:     (C, 2) [lower, upper] bin pair per channel; single-bin
              channels repeat the same index twice (wide == lo != hi)
    offsets:  (C,) residual frequency offset (Hz) to mix OUT of each
              stream (requested_center - served_center)
    rate:     per-channel output sample rate (2x bin spacing; the
              two-bin synthesizer output runs at the same rate)
    """
    bins: np.ndarray
    offsets: np.ndarray
    rate: float

    @property
    def count(self) -> int:
        return len(self.bins)

    @property
    def wide(self) -> np.ndarray:
        return self.bins[:, 0] != self.bins[:, 1]


def plan_channels(channelizer: Channelizer, center_offsets_hz,
                  bandwidths_hz=None) -> ChannelPlan:
    """Plan bin assignment for channels at given baseband offsets (Hz).

    A channel whose bandwidth fits one bin takes the nearest bin; a wider
    one (up to 2x spacing) takes the straddling pair, served by the
    two-channel synthesizer centered midway between them
    (ChannelCalculator.java:223, :515). Wider than two bins raises, as in
    the reference (PolyphaseChannelManager.java:164-178).

    bandwidths_hz: scalar or (C,) per-channel bandwidth; None = one bin.
    """
    offsets = np.atleast_1d(np.asarray(center_offsets_hz, dtype=np.float64))
    spacing = channelizer.channel_spacing
    if bandwidths_hz is None:
        bw = np.full(len(offsets), spacing)
    else:
        bw = np.broadcast_to(
            np.asarray(bandwidths_hz, np.float64), offsets.shape).copy()
    if np.any(bw > 2.0 * spacing + 1e-6):
        raise ValueError(
            f"channel bandwidth > {2 * spacing:.0f} Hz needs more than two "
            "bins; not supported (reference supports one- and two-channel "
            "output processors only)")

    m_total = channelizer.channels
    bins = np.zeros((len(offsets), 2), np.int64)
    residual = np.zeros(len(offsets))
    for i, (f, w) in enumerate(zip(offsets, bw)):
        if w <= spacing + 1e-6:
            b = channelizer.channel_for_frequency(f)
            bins[i] = (b, b)
            residual[i] = f - channelizer.center_frequency(int(b))
        else:
            m = int(round(f / spacing - 0.5))
            bins[i] = (m % m_total, (m + 1) % m_total)
            residual[i] = f - (channelizer.center_frequency(m)
                               + spacing / 2.0)
        if abs(residual[i]) > spacing / 2 + 1e-6:
            raise ValueError("requested offset outside channelizer "
                             "coverage")
    return ChannelPlan(bins=bins, offsets=residual,
                       rate=channelizer.channel_sample_rate)


def extract_channels(y: torch.Tensor, plan: ChannelPlan, phase=None,
                     gain: float = 1.0, start: int = 0
                     ) -> tuple[torch.Tensor, tuple]:
    """Extract per-channel streams from channelizer output.

    y: (K, M) complex64 channelizer output blocks.
    phase: None or (mixer_phase (C,) float32, rot_k int) carried across
    chunks for phase-continuous streaming (rot_k is the two-bin
    synthesizer's e^{-i pi k/2} rotator index, shared by all channels).
    start: the index of y's first block within the chunk the phase
    belongs to (a time shard's offset, parallel/pipeline.py): the mixer
    and the rotator run at start + k, with the same arithmetic as one call
    on the whole chunk, so a shard's streams equal that call's columns.
    Returns (streams (C, K) complex64 mixed to true baseband,
    (next_mixer_phase, next_rot_k)): the phase K blocks on, the next
    chunk's when start is 0.
    """
    dev = y.device
    if phase is None:
        phase = (torch.zeros((plan.count,), dtype=torch.float32,
                             device=dev), 0)
    mixer_phase, rot_k = phase
    k = y.shape[0]
    bins = torch.as_tensor(plan.bins, device=dev)
    lo = y[:, bins[:, 0]]                              # (K, C)
    hi = y[:, bins[:, 1]]
    blocks = torch.arange(start, start + k, device=dev)
    rot = rot4(dev)[(int(rot_k) + blocks) % 4][:, None]
    z = rot * lo - torch.conj(rot) * hi                # two-bin synthesis
    wide = torch.as_tensor(plan.wide, device=dev)[None, :]
    streams = torch.where(wide, z, lo).T               # (C, K)

    step = torch.as_tensor((TWO_PI * plan.offsets / plan.rate)
                           .astype(np.float32), device=dev)
    n = blocks.to(torch.float32)[None, :]     # exact below 2^24 blocks
    angles = mixer_phase[:, None] + step[:, None] * n
    out = streams * torch.complex(torch.cos(angles), -torch.sin(angles)) \
        * gain
    next_phase = torch.remainder(mixer_phase + step * k, TWO_PI)
    return out.to(torch.complex64), (next_phase, (int(rot_k) + k) % 4)
