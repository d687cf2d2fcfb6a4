"""Synthesis helpers (port of sdrtrunk_tpu/dsp/synthesizer.py).

The two-channel M/2 synthesizer re-joins two adjacent 2x-oversampled
channelizer bins into one wider stream (the role of the reference's
TwoChannelSynthesizerM2.java:45). Against this package's channelizer
convention (bin m centered at +m*fs/M, hop M/2) it reduces to a closed
form with no synthesis filter:

    z[k] = e^{-i pi k/2} c_m[k]  -  e^{+i pi k/2} c_{m+1}[k]

the lower bin shifted down and the upper up by fs_ch/4 and summed; the
analysis prototype's perfect-reconstruction band edge makes the joint
response flat (tests/test_misc_dsp.py measures it). ``ROT4`` is that
e^{-i pi k/2} cycle. ``synthesize_bank`` is the full M-channel polyphase
synthesis bank, the exact dual of the channelizer's analysis bank; it
builds wideband captures from per-bin streams on the device.
``synthesize_bank_host`` is the reference's NumPy synthesis bank itself,
the same float operations in the same order, so that a scene built with
it holds the reference's bytes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device

__all__ = ["ROT4", "rot4", "synthesize_two", "TwoChannelSynthesizer",
           "synthesize_bank", "synthesize_bank_host"]

# e^{-i pi k / 2} cycle
ROT4 = (1 + 0j, -1j, -1 + 0j, 1j)


def rot4(device) -> torch.Tensor:
    return torch.tensor(ROT4, dtype=torch.complex64, device=device)


def synthesize_two(c_lo: torch.Tensor, c_hi: torch.Tensor, state=None):
    """Combine adjacent bin streams (lower, upper) into one wide stream.

    c_lo, c_hi: (..., K) complex at the 2x-oversampled channel rate (equal
    shapes; leading axes are a batch of channel pairs). state: the
    rotator index k0 (mod 4), a 0-d int32 tensor, or None for 0.
    Returns (z complex64 (..., K) centered midway between the two bins,
    the next rotator index).
    """
    dev = c_lo.device
    k = c_lo.shape[-1]
    if state is None:
        state = torch.zeros((), dtype=torch.int32, device=dev)
    rot = rot4(dev)[(state + torch.arange(k, device=dev)) % 4]
    z = rot * c_lo.to(torch.complex64) \
        - torch.conj(rot) * c_hi.to(torch.complex64)
    return z, (state + k) % 4


@dataclass
class TwoChannelSynthesizer:
    """Streaming ``synthesize_two`` carrying the rotator index across
    chunks. channel_sample_rate is informational (the output rate equals
    it)."""
    channel_sample_rate: float
    device: str = "cuda"

    def init_state(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32,
                           device=resolve_device(self.device))

    def __call__(self, c_lo, c_hi, state=None):
        return synthesize_two(c_lo, c_hi, state)


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


def synthesize_bank_host(u: np.ndarray, hmat: np.ndarray) -> np.ndarray:
    """``synthesize_bank`` in NumPy on the host, as the reference computes
    it (sdrtrunk_tpu/dsp/synthesizer.py ``synthesize_bank``): the inverse
    FFT in u's precision (complex64 for a complex64 u), the two scalings
    one after the other, each window product in complex64 and the
    overlap-add accumulated in complex128, block by block in the same
    order. The reference tiles v (rolled on odd blocks) T times and
    multiplies the (K, T*M) whole by the prototype; its column block b is
    v's half b % 2, so each block's product is taken from v as it is
    added, the same values without the (K, T*M) arrays. Returns x
    complex64 (K*M/2 + (2*T-1)*M/2,) equal to the reference's byte for
    byte.
    """
    u = np.asarray(u)
    hmat = np.asarray(hmat)
    t_taps, m = hmat.shape
    k = u.shape[0]
    half = m // 2
    v = np.fft.ifft(u, axis=1) * m * (m / 2.0)             # (K, M)
    g = hmat.reshape(-1)                                   # (T*M,)
    par = (np.arange(k) & 1)[:, None]
    v = np.where(par == 1, np.roll(v, -half, axis=1), v)
    acc = np.zeros((k + 2 * t_taps, half), np.complex128)
    for b in range(2 * t_taps):
        lo = (b % 2) * half
        acc[b:b + k] += v[:, lo:lo + half] * g[None, b * half:(b + 1) * half]
    return acc.reshape(-1).astype(np.complex64)
