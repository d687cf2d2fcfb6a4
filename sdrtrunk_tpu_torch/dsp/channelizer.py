"""M/2 polyphase channelizer (port of sdrtrunk_tpu/dsp/channelizer.py).

All output blocks of a time slice are computed at once:

    u[k, r]  = sum_q h[q*M + r] * x[k*M/2 - q*M - r]      (branch filter)
    y[k, m]  = (-1)^{m*k} * M * IFFT_M(u[k, :])[m]         (phase alignment)

On a CUDA tensor the branch sums are one kernel (csrc/channelize.cu, via
``dsp/channelize_cuda.py``); on the CPU they are ``branch_sums_plain``, T
shifted multiply-adds over reversed (rows, M) views of the padded input (no
gathers), the same products summed in the same order. The IFFT is
``torch.fft.ifft`` batched over all blocks. Channel m is centered at
+m * fs/M (negative frequencies wrap); the output rate is 2*fs/M per
channel.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import design

from .. import resolve_device

__all__ = ["Channelizer", "branch_sums_plain", "channel_count_for_rate",
           "channelize", "channelize_core", "channelize_core_plain",
           "polyphase_branch_filters"]


def channel_count_for_rate(sample_rate: float,
                           channel_bandwidth: float = 12500.0) -> int:
    """channels = floor(fs / bw) rounded down to even
    (ComplexPolyphaseChannelizerM2.java:148-161)."""
    channels = int(sample_rate / channel_bandwidth)
    if channels % 2 != 0:
        channels -= 1
    return channels


def polyphase_branch_filters(taps: np.ndarray, channels: int) -> np.ndarray:
    """Reshape prototype h[n] -> hmat[q, r] = h[q*M + r], shape (T, M)."""
    taps = np.asarray(taps, dtype=np.float64)
    m = channels
    t = int(np.ceil(len(taps) / m))
    padded = np.zeros(t * m)
    padded[: len(taps)] = taps
    return padded.reshape(t, m)


def channelize_core(xp: torch.Tensor, hmat: torch.Tensor) -> torch.Tensor:
    """Channelize a padded complex block (the reference's _channelize_core).

    xp: complex64 (H + N,) with H = T*M history samples before the block
        and N a multiple of M (two output blocks per M samples).
    hmat: float32 (T, M) polyphase branches.
    Returns y: complex64 (K, M) with K = 2*N/M.

    A CPU tensor runs ``channelize_core_plain``; any other tensor launches
    the branch-sum kernel of ``dsp/channelize_cuda.py`` (which launches or
    raises) ahead of the inverse FFT. Where M is a power of two the IFFT's
    1/M and the plain version's * M are both exact, so the kernel path
    takes the unscaled transform (``norm="forward"``) and equals the plain
    version bit for bit; for any other M it keeps both passes.
    """
    if xp.device.type == "cpu":
        return channelize_core_plain(xp, hmat)
    from .channelize_cuda import channelize_cuda
    u = channelize_cuda(xp, hmat)
    m = u.shape[1]
    if m & (m - 1) == 0:
        y = torch.fft.ifft(u, dim=-1, norm="forward")
    else:
        y = torch.fft.ifft(u, dim=-1) * m
    return _align_odd_blocks(y)


def branch_sums_plain(xp: torch.Tensor, hmat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the branch-sum kernel: u (K, M) complex64,
    u[b, r] = sum_q hmat[q, r] xp[(b + 2 (T - q)) M/2 - r], on each plane
    from the q = 0 product, then q = 1, ..., T - 1 in order."""
    t, m = hmat.shape
    n = xp.shape[0] - m * t
    k = 2 * n // m                # output blocks (hop M/2)
    kp = k // 2
    half = m // 2
    # On the reversed signal the branch windows of even blocks
    # (x[p*M - s]) and odd blocks (x[p*M + M/2 - s]) are contiguous
    # ascending rows of an (rows, M) reshape after dropping M-1 resp.
    # M/2-1 leading samples; planes are [re, im] as a trailing axis.
    v = torch.view_as_real(xp.flip(0))
    rows = kp + t - 1

    def branch_sums(start: int) -> torch.Tensor:
        chunks = v[start:start + rows * m].reshape(rows, m, 2)
        acc = hmat[0][:, None] * chunks[0:kp]
        for q in range(1, t):
            acc = acc + hmat[q][:, None] * chunks[q:q + kp]
        return acc.flip(0)        # newest-block-first -> block order

    u = torch.stack([branch_sums(m - 1), branch_sums(half - 1)], dim=1)
    return torch.view_as_complex(u.reshape(k, m, 2))


def channelize_core_plain(xp: torch.Tensor, hmat: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of ``channelize_core``: the plain branch sums,
    then ``ifft(u) * M`` and the odd blocks' half-bin rotation."""
    u = branch_sums_plain(xp, hmat)
    y = torch.fft.ifft(u, dim=-1) * u.shape[1]
    return _align_odd_blocks(y)


def _align_odd_blocks(y: torch.Tensor) -> torch.Tensor:
    """Odd blocks carry the M/2 hop's half-bin rotation (-1)^m: negate
    their odd bins, in place on y."""
    odd = torch.view_as_real(y)[1::2, 1::2]
    odd.neg_()
    return y


class Channelizer(nn.Module):
    """Streaming M/2 polyphase channelizer; ``hmat`` is a buffer.

    Usage:
        ch = Channelizer.design(2_400_000, 12500, device="cuda")
        y, state = ch(x, state)        # x: (N,) complex64, N % M == 0
    State is the trailing T*M input samples, so chunked streaming matches
    one-shot processing exactly.
    """

    def __init__(self, hmat: np.ndarray, sample_rate: float, device="cuda"):
        super().__init__()
        self.taps_per_channel, self.channels = hmat.shape
        self.sample_rate = sample_rate
        self.register_buffer("hmat", torch.as_tensor(
            np.asarray(hmat, np.float32), device=resolve_device(device)))

    @classmethod
    def design(cls, sample_rate: float, channel_bandwidth: float = 12500.0,
               taps_per_channel: int = 9, channels: int | None = None,
               device="cuda") -> "Channelizer":
        if channels is None:
            channels = channel_count_for_rate(sample_rate, channel_bandwidth)
        if channels < 2 or channels % 2:
            raise ValueError(f"invalid channel count {channels}")
        spacing = sample_rate / channels
        proto = design.sinc_m2_channelizer(spacing, channels, taps_per_channel)
        return cls(polyphase_branch_filters(proto, channels), sample_rate,
                   device=device)

    @classmethod
    def from_taps(cls, taps: np.ndarray, sample_rate: float, channels: int,
                  device="cuda") -> "Channelizer":
        """A channelizer of M = ``channels`` bins over the prototype
        low-pass ``taps``."""
        return cls(polyphase_branch_filters(taps, channels), sample_rate,
                   device=device)

    @property
    def channel_spacing(self) -> float:
        return self.sample_rate / self.channels

    @property
    def channel_sample_rate(self) -> float:
        """Per-channel output rate: 2x oversampled (spacing * 2)."""
        return 2.0 * self.sample_rate / self.channels

    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.taps_per_channel * self.channels,),
                           dtype=torch.complex64, device=self.hmat.device)

    def center_frequency(self, channel_index: int) -> float:
        """Baseband center frequency of a channel (wraps to negative)."""
        m = channel_index % self.channels
        if m > self.channels // 2:
            m -= self.channels
        return m * self.channel_spacing

    def channel_for_frequency(self, frequency: float) -> int:
        """Nearest bin index for a baseband offset frequency."""
        m = int(round(frequency / self.channel_spacing))
        return m % self.channels

    def forward(self, x: torch.Tensor, state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        if state is None:
            state = self.init_state()
        m = self.channels
        if x.shape[0] % m:
            raise ValueError(f"block length {x.shape[0]} must be a multiple "
                             f"of M={m}")
        xp = torch.cat([state, x.to(torch.complex64)])
        return channelize_core(xp, self.hmat), xp[-state.shape[0]:]


def channelize(x: torch.Tensor, taps: np.ndarray, channels: int,
               sample_rate: float = 1.0) -> torch.Tensor:
    """One-shot channelization of x with zero history, on x's device."""
    y, _ = Channelizer.from_taps(taps, sample_rate, channels,
                                 device=x.device)(x)
    return y
