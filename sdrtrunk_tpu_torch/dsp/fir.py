"""Streaming FIR filtering and resampling (port of sdrtrunk_tpu/dsp/fir.py).

Batched over channels: x is (C, T) and the carried history (C, taps-1),
so chunked filtering equals one-shot filtering. Each filter is a
``conv1d`` over the real and imaginary planes; the package disables TF32
at import, so on the card it runs in full float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["fir_init", "fir_apply", "fir_filter", "fir_filter_bank",
           "fir_decimate",
           "half_band_decimate", "decimation_cascade_taps",
           "decimate_by_power2", "resample_taps", "resample_init",
           "polyphase_resample"]


def fir_init(taps_len: int, dtype=torch.complex64, device="cuda"
             ) -> torch.Tensor:
    """Zero history for a streaming FIR (taps_len - 1 samples)."""
    return torch.zeros((taps_len - 1,), dtype=dtype, device=device)


def _conv_planes(xp: torch.Tensor, kernel: torch.Tensor,
                 stride: int = 1) -> torch.Tensor:
    """conv1d (a correlation) of each row of (C, L) real or complex xp
    with a (O, K) real kernel bank: (C, O, L') in xp's dtype."""
    c, n = xp.shape
    planes = torch.view_as_real(xp).permute(0, 2, 1) if xp.is_complex() \
        else xp[:, None, :]                                # (C, P, L)
    p = planes.shape[1]
    y = F.conv1d(planes.reshape(c * p, 1, n),
                 kernel.to(torch.float32)[:, None, :], stride=stride)
    y = y.reshape(c, p, *y.shape[1:])                      # (C, P, O, L')
    if xp.is_complex():
        return torch.view_as_complex(y.permute(0, 2, 3, 1).contiguous())
    return y[:, 0]


def fir_apply(x: torch.Tensor, taps: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """y[c, n] = sum_k taps[k] * x[c, n - k], with x[c, -j] drawn from
    ``state`` (C, K-1). x is (C, T) real or complex. Returns (y (C, T),
    new history (C, K-1))."""
    return fir_decimate(x, taps, 1, state)


def fir_filter(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """One-shot FIR with zero initial history."""
    return fir_decimate(x, taps, 1)[0]


def fir_filter_bank(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """One-shot FIR of each row of (C, T) x with each of the O tap sets of
    (O, K) ``taps``, from zero history: (C, O, T) in one ``conv1d``."""
    return _conv_planes(F.pad(x, (taps.shape[1] - 1, 0)), taps.flip(1))


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, factor: int,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """FIR + decimate by ``factor`` (T a multiple of factor): fir_apply
    followed by [:, ::factor], computed by a strided conv so only kept
    outputs are evaluated. Returns (y, new history (C, K-1))."""
    k = taps.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (C, K-1+T)
    # conv1d correlates, so the kernel is the reversed taps
    y = _conv_planes(xp, taps.flip(0)[None, :], stride=factor)[:, 0]
    return y, xp[:, xp.shape[1] - (k - 1):]


def half_band_decimate(x: torch.Tensor, taps: torch.Tensor,
                       state: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x2 half-band decimator."""
    return fir_decimate(x, taps, 2, state)


def decimation_cascade_taps(factor: int, order: int = 22
                            ) -> list[np.ndarray]:
    """Half-band tap sets for a x2..x1024 dyadic decimation cascade: a
    chain of log2(factor) half-band stages."""
    from . import design
    if factor & (factor - 1) or factor < 2:
        raise ValueError("decimation factor must be a power of two >= 2")
    return [design.half_band(order) for _ in range(int(np.log2(factor)))]


def decimate_by_power2(x: torch.Tensor, stage_taps: list,
                       states: list | None = None
                       ) -> tuple[torch.Tensor, list]:
    """Run a dyadic half-band cascade; returns (y, new states)."""
    if states is None:
        states = [None] * len(stage_taps)
    new_states = []
    for taps, st in zip(stage_taps, states):
        x, ns = half_band_decimate(
            x, torch.as_tensor(np.asarray(taps, np.float32),
                               device=x.device), st)
        new_states.append(ns)
    return x, new_states


def resample_taps(up: int, down: int, taps_per_phase: int = 12,
                  attenuation_db: float = 80.0) -> np.ndarray:
    """Polyphase resampler prototype (windowed sinc), zero-padded to a
    multiple of ``up``."""
    from . import design
    length = up * taps_per_phase
    if length % 2 == 0:
        length += 1
    taps = design.kaiser_sinc(length, 0.5 / max(up, down),
                              attenuation_db) * up
    return np.concatenate([taps, np.zeros((-len(taps)) % up)])


def resample_init(taps_len: int, up: int, dtype=torch.float32,
                  device="cuda") -> torch.Tensor:
    """Zero history for streaming polyphase_resample (taps_len // up
    samples)."""
    return torch.zeros((taps_len // up,), dtype=dtype, device=device)


def polyphase_resample(x: torch.Tensor, taps: torch.Tensor, up: int,
                       down: int, state: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Rational-rate resampling of (C, n) x by up/down, upfirdn-aligned:

        y[c, m] = sum_j poly[(m*down) % up, j] * x[c, (m*down)//up - j]

    with poly[p, j] = taps[j*up + p] and x[c, -1 .. -tpp] drawn from
    ``state`` (C, tpp), tpp = len(taps) // up. Output m = q*up + r reads
    from input q*down + (r*down)//up, so each of the up output phases r is
    a stride-``down`` correlation of the history-padded stream with its
    polyphase branch, placed at offset (r*down)//up in one (up, K) kernel
    bank: one strided conv1d evaluates only the kept outputs. Streaming
    with n a multiple of down keeps the phase pattern block-periodic, and
    the caller carries x[:, -tpp:] as the next state.
    """
    taps = taps.to(torch.float32)
    tpp = taps.shape[0] // up
    c, n = x.shape
    n_out = n * up // down
    if state is None:
        state = torch.zeros((c, tpp), dtype=x.dtype, device=x.device)
    poly = taps.reshape(tpp, up).T                         # (up, tpp)
    off = [r * down // up for r in range(up)]
    klen = max(off) + tpp + 1
    # kernel[r, o_r + tpp - j] = poly[(r*down) % up, j]
    bank = torch.zeros((up, klen), dtype=torch.float32, device=x.device)
    for r, o in enumerate(off):
        bank[r, o + 1:o + tpp + 1] = poly[(r * down) % up].flip(0)
    q = -(-n_out // up)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (C, tpp + n)
    pad = max((q - 1) * down + klen - xp.shape[1], 0)
    xp = F.pad(xp, (0, pad)) if pad else xp
    y = _conv_planes(xp, bank, stride=down)[:, :, :q]      # (C, up, Q)
    return y.transpose(1, 2).reshape(c, q * up)[:, :n_out]
