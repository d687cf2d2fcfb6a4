"""``c4fm``: 4-level FM at the symbol rate, +/-600 and +/-1800 Hz,
through the standard's C4FM pulse (raised cosine, alpha 0.2, with its
inverse-sinc shaping), of a dibit sequence in a data file beside the
mix (``dibits``), repeated; each slot starts at its own seeded point of
it, within ``start_spread_periods`` periods of the sequence.
"""
from __future__ import annotations

import numpy as np
import torch

from ...reference import dsp
from ..generator import read_dibits

C4FM_DEVIATION_HZ = 600.0          # one symbol unit (TIA-102.BAAA)
DIBIT_LEVELS = np.array([1.0, 3.0, -1.0, -3.0])


def c4fm_pulse(alpha: float = 0.2, span: int = 12, res: int = 64):
    """TIA-102.BAAA's C4FM frequency pulse on a grid of 1 / res symbol:
    the raised-cosine Nyquist filter cascaded with the shaping filter
    P(f) = (pi f T) / sin(pi f T), by a cosine transform of the product,
    scaled so that a train of equal symbols sums to their level. Returns
    (times in symbols, values)."""
    fmax = (1.0 + alpha) / 2.0
    f = np.linspace(0.0, fmax, 2048)
    f1 = (1.0 - alpha) / 2.0
    h = np.where(f > f1, 0.5 * (1.0 + np.cos(np.pi / alpha * (f - f1))), 1.0)
    x = np.maximum(np.pi * f, 1e-12)
    h = h * np.where(f > 0, x / np.sin(np.minimum(x, np.pi - 1e-9)), 1.0)
    t = np.arange(-span // 2 * res, span // 2 * res + 1) / res
    return t, 2.0 * np.trapezoid(
        h[None, :] * np.cos(2.0 * np.pi * t[:, None] * f[None, :]), f, axis=1)


def c4fm_baseband(dibits: np.ndarray, n: int, rate: float,
                  symbol_rate: float, span: int = 12) -> np.ndarray:
    """n samples of the repeated dibit sequence as C4FM: the symbol
    levels through the C4FM pulse, evaluated at each sample's true
    fractional symbol time, then frequency modulated at 600 Hz a level."""
    sps = rate / symbol_rate
    nsym = int(np.ceil(n / sps)) + span
    levels = DIBIT_LEVELS[np.resize(dibits, nsym)]
    grid, pulse = c4fm_pulse(span=span)
    t = np.arange(n) / sps
    k0 = np.floor(t).astype(np.int64)
    msg = np.zeros(n)
    for d in range(-span // 2, span // 2 + 1):
        k = k0 + d
        ok = (k >= 0) & (k < nsym)
        msg += np.where(ok, levels[np.clip(k, 0, nsym - 1)]
                        * np.interp(t - k, grid, pulse, 0.0, 0.0), 0.0)
    phase = dsp.TWO_PI * C4FM_DEVIATION_HZ * np.cumsum(msg) / rate
    return np.exp(1j * phase)


def make(entry: dict, rows: list, rng, rate: float, samples: int,
         device) -> dict:
    dib = read_dibits(entry["dibits"])
    period = len(dib) * rate / entry["symbol_rate_hz"]
    starts = rng.integers(
        0, int(entry.get("start_spread_periods", 1) * period), len(rows))
    n = int(starts.max()) + samples + 1
    base = c4fm_baseband(dib, n, rate, entry["symbol_rate_hz"])
    return {"base": torch.as_tensor(base, device=device),
            "starts": torch.as_tensor(starts, device=device)}


def fill(part: dict, n: torch.Tensor) -> torch.Tensor:
    return part["base"][part["starts"][:, None] + n.long()[None, :]]
