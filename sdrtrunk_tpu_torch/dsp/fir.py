"""Streaming FIR filtering (port of sdrtrunk_tpu/dsp/fir.py:31-70).

Batched over channels: x is (C, T) and the carried history (C, taps-1),
so chunked filtering equals one-shot filtering. The convolution is
``conv1d`` over the real and imaginary planes; the package disables TF32
at import, so on the card it runs in full float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fir_init", "fir_apply"]


def fir_init(taps_len: int, dtype=torch.complex64, device="cuda"
             ) -> torch.Tensor:
    """Zero history for a streaming FIR (taps_len - 1 samples)."""
    return torch.zeros((taps_len - 1,), dtype=dtype, device=device)


def fir_apply(x: torch.Tensor, taps: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """y[c, n] = sum_k taps[k] * x[c, n - k], with x[c, -j] drawn from
    ``state`` (C, K-1). x is (C, T) real or complex. Returns (y (C, T),
    new history (C, K-1))."""
    k = taps.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (C, K-1+T)
    c, n = xp.shape
    planes = torch.view_as_real(xp).permute(0, 2, 1) if xp.is_complex() \
        else xp[:, None, :]                                # (C, P, L)
    p = planes.shape[1]
    # conv1d correlates, so the kernel is the reversed taps
    y = F.conv1d(planes.reshape(c * p, 1, n),
                 taps.flip(0).to(torch.float32)[None, None, :])
    y = y.reshape(c, p, n - k + 1)
    if xp.is_complex():
        y = torch.view_as_complex(y.permute(0, 2, 1).contiguous())
    else:
        y = y[:, 0]
    return y, xp[:, n - (k - 1):]
