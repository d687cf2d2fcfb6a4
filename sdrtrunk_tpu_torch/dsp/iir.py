"""First-order IIR as blocked matmuls (port of sdrtrunk_tpu/dsp/iir.py:32-137).

y[t] = a*y[t-1] + b[t] with a constant pole has the closed form
y[t] = a^(t+1)*y0 + sum_j a^(t-j) b[j], which blocks into a lower-
triangular (L, L) matmul per block plus a small carry matmul across
blocks — the same structure as the reference, batched over channels.
These are plain ``torch.matmul``s (TF32 is off, so float32 on the card).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..runtime.tracing import h2d_once

__all__ = ["single_pole", "single_pole_apply", "dc_removal",
           "deemphasis_alpha", "deemphasis_makeup_gain", "deemphasis"]


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
    a = float(a)
    a_l = a ** block
    dev = b.device

    def const(name: str, build) -> torch.Tensor:
        # made on the host and copied once per pole, shape and device
        return h2d_once(("linrec." + name, a, block, nb), build,
                        dtype=torch.float32, device=dev)

    bp = torch.nn.functional.pad(b, (0, nb * block - n)).reshape(c, nb, block)
    t_mat = const("t", lambda: _tri_powers(a, block))
    s_mat = const("s", lambda: _carry_powers(a_l, nb))
    y0_pow = const("y0", lambda: _powers(a_l, 0, nb))
    in_pow = const("in", lambda: _powers(a, 1, block + 1))
    partial = torch.matmul(bp, t_mat.T)                   # (C, nb, L)
    ends = partial[:, :, -1]                              # (C, nb)
    c_in = torch.matmul(ends, s_mat.T) + y0_pow * y0[:, None]
    y = in_pow * c_in[:, :, None] + partial
    return y.reshape(c, -1)[:, :n]


def _carry_powers(a_l: float, nb: int) -> np.ndarray:
    """(nb, nb) S[i, j] = a_l^(i-1-j) for j < i, else 0: block j's end
    carried into block i."""
    s_mat = np.zeros((nb, nb))
    if nb > 1:
        s_mat[1:, :-1] = _tri_powers(a_l, nb - 1)
    return s_mat


def _powers(a: float, start: int, stop: int) -> np.ndarray:
    """a^k for k in [start, stop)."""
    with np.errstate(under="ignore"):
        return np.power(a, np.arange(start, stop))


def single_pole(x: torch.Tensor, alpha: float, y0=0.0) -> torch.Tensor:
    """y[t] = y[t-1] + alpha*(x[t]-y[t-1]) over (C, T) real x from
    y[-1] = y0, (C,) or one value for every channel."""
    y0 = torch.as_tensor(y0, dtype=x.dtype, device=x.device)
    return _linrec(1.0 - alpha, alpha * x, y0.expand(x.shape[:1]))


def single_pole_apply(x: torch.Tensor, alpha: float, state: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming single-pole IIR; ``state`` (C,) is the previous output."""
    y = single_pole(x, alpha, state)
    return y, y[:, -1]


def dc_removal(x: torch.Tensor, ratio: float = 0.95,
               state: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """DC-blocking filter y[t] = x[t] - x[t-1] + ratio*y[t-1] over (C, T)
    real x; ``state`` is (x_prev (C,), y_prev (C,)), zeros for None."""
    if state is None:
        zero = torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
        state = (zero, zero)
    x_prev, y_prev = state
    diffs = x - torch.cat([x_prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)
    y = _linrec(float(ratio), diffs, y_prev)
    return y, (x[:, -1], y[:, -1])


def deemphasis_alpha(sample_rate: float, tau: float = 750e-6) -> float:
    """One-pole de-emphasis coefficient for time constant tau (750 us,
    the land-mobile standard)."""
    return 1.0 - math.exp(-1.0 / (sample_rate * tau))


def deemphasis_makeup_gain(sample_rate: float, tau: float = 750e-6,
                           reference_hz: float = 1000.0) -> float:
    """Gain restoring unity response at ``reference_hz`` after
    de-emphasis (|H| of y[t] = (1-alpha) y[t-1] + alpha x[t])."""
    alpha = deemphasis_alpha(sample_rate, tau)
    w = 2.0 * math.pi * reference_hz / sample_rate
    re = 1.0 - (1.0 - alpha) * math.cos(w)
    im = (1.0 - alpha) * math.sin(w)
    return math.hypot(re, im) / alpha


def deemphasis(x: torch.Tensor, sample_rate: float, tau: float = 750e-6,
               state: torch.Tensor | None = None, gain: float | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """FM de-emphasis over (C, T) real x: single pole, then the makeup
    gain (unity at 1 kHz by default), then a clip at +/-0.95. Returns
    (audio, new state (C,)); the state is the filter output before the
    gain."""
    if state is None:
        state = torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
    y = single_pole(x, deemphasis_alpha(sample_rate, tau), state)
    if gain is None:
        gain = deemphasis_makeup_gain(sample_rate, tau)
    return torch.clamp(y * gain, -0.95, 0.95), y[:, -1]
