"""Synthesis helpers (port of sdrtrunk_tpu/dsp/synthesizer.py:46, :82-123).

``ROT4`` is the two-bin join's e^{-i pi k/2} cycle. ``synthesize_bank`` is
the full M-channel polyphase synthesis bank, the exact dual of the
channelizer's analysis bank; it builds wideband captures from per-bin
streams on the device (the reference does this in NumPy on the host).
"""
from __future__ import annotations

import torch

__all__ = ["ROT4", "rot4", "synthesize_bank"]

# e^{-i pi k / 2} cycle
ROT4 = (1 + 0j, -1j, -1 + 0j, 1j)


def rot4(device) -> torch.Tensor:
    return torch.tensor(ROT4, dtype=torch.complex64, device=device)


def synthesize_bank(u: torch.Tensor, hmat: torch.Tensor) -> torch.Tensor:
    """Multiplex per-bin streams into one wideband signal.

    u: (K, M) complex — per-bin content at the channel hop rate (bin m
       centered at +m*fs/M).
    hmat: (T, M) float prototype branches (Channelizer.hmat).
    Returns x: complex64 (K*M/2 + (2*T-1)*M/2,) on u's device
    (overlap-add tail kept); analysis(synthesize_bank(u)) returns u
    delayed by T-1 blocks with about unit gain.
    """
    t_taps, m = hmat.shape
    k = u.shape[0]
    half = m // 2
    # v[k, r] = sum_m u[k,m] e^{+2 pi i m r / M}; the extra M/2 gives the
    # analysis-of-synthesis round trip unit gain
    v = torch.fft.ifft(u.to(torch.complex64), dim=1) * (m * (m / 2.0))
    g = hmat.reshape(-1).to(torch.float32)                 # (T*M,)
    # block k contributes g[j] * v[k, (k*M/2 + j) mod M] at output
    # k*M/2 + j: odd blocks see v rolled by half a bin
    v = torch.where((torch.arange(k, device=u.device) & 1)[:, None] == 1,
                    torch.roll(v, -half, dims=1), v)
    win = v.repeat(1, t_taps) * g[None, :]                 # (K, T*M)
    w3 = win.reshape(k, 2 * t_taps, half)
    acc = torch.zeros((k + 2 * t_taps, half), dtype=torch.complex64,
                      device=u.device)
    for b in range(2 * t_taps):
        acc[b:b + k] += w3[:, b, :]
    return acc.reshape(-1)
