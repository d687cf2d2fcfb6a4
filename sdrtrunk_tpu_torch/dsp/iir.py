"""First-order IIR as blocked matmuls (port of sdrtrunk_tpu/dsp/iir.py:32-86).

y[t] = a*y[t-1] + b[t] with a constant pole has the closed form
y[t] = a^(t+1)*y0 + sum_j a^(t-j) b[j], which blocks into a lower-
triangular (L, L) matmul per block plus a small carry matmul across
blocks — the same structure as the reference, batched over channels.
These are plain ``torch.matmul``s (TF32 is off, so float32 on the card).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["single_pole", "single_pole_apply"]


def _tri_powers(a: float, size: int) -> np.ndarray:
    """Lower-triangular P[i, j] = a^(i-j) for j <= i, else 0."""
    i = np.arange(size)
    with np.errstate(under="ignore"):
        p = np.power(float(a), np.maximum(i[:, None] - i[None, :], 0))
    return np.tril(p)


def _linrec(a: float, b: torch.Tensor, y0: torch.Tensor,
            block: int = 128) -> torch.Tensor:
    """Solve y[c, t] = a*y[c, t-1] + b[c, t] with y[c, -1] = y0[c]."""
    c, n = b.shape
    nb = -(-n // block)
    dev = b.device
    bp = torch.nn.functional.pad(b, (0, nb * block - n)).reshape(c, nb, block)
    t_mat = torch.as_tensor(_tri_powers(a, block), dtype=torch.float32,
                            device=dev)
    partial = torch.matmul(bp, t_mat.T)                   # (C, nb, L)
    a_l = float(a) ** block
    s_mat = np.zeros((nb, nb))
    if nb > 1:
        s_mat[1:, :-1] = _tri_powers(a_l, nb - 1)
    with np.errstate(under="ignore"):
        y0_pow = np.power(a_l, np.arange(nb))
        in_pow = np.power(float(a), np.arange(1, block + 1))
    ends = partial[:, :, -1]                              # (C, nb)
    c_in = (torch.matmul(ends, torch.as_tensor(s_mat, dtype=torch.float32,
                                               device=dev).T)
            + torch.as_tensor(y0_pow, dtype=torch.float32, device=dev)
            * y0[:, None])
    y = (torch.as_tensor(in_pow, dtype=torch.float32, device=dev)
         * c_in[:, :, None] + partial)
    return y.reshape(c, -1)[:, :n]


def single_pole(x: torch.Tensor, alpha: float, y0) -> torch.Tensor:
    """y[t] = y[t-1] + alpha*(x[t]-y[t-1]) over (C, T) real x."""
    return _linrec(1.0 - alpha, alpha * x, y0)


def single_pole_apply(x: torch.Tensor, alpha: float, state: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming single-pole IIR; ``state`` (C,) is the previous output."""
    y = single_pole(x, alpha, state)
    return y, y[:, -1]
