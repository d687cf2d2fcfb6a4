"""Window functions for FIR design (host-side NumPy, not in any hot path).

Functional surface mirrors the window menu of the reference
(dsp/filter/Window.java:467+: BLACKMAN, BLACKMAN_HARRIS_4/7, COSINE, FLAT_TOP,
HAMMING, HANN, KAISER, ...); implementations are standard textbook formulas.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "blackman", "blackman_harris_4", "blackman_harris_7", "cosine", "flat_top",
    "hamming", "hann", "kaiser", "kaiser_beta", "rectangular", "get_window",
]


def _n(length: int) -> np.ndarray:
    return np.arange(length, dtype=np.float64)


def rectangular(length: int) -> np.ndarray:
    return np.ones(length, dtype=np.float64)


def hann(length: int) -> np.ndarray:
    n = _n(length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))


def hamming(length: int) -> np.ndarray:
    n = _n(length)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))


def cosine(length: int) -> np.ndarray:
    n = _n(length)
    return np.sin(np.pi * n / (length - 1))


def blackman(length: int) -> np.ndarray:
    n = _n(length)
    x = 2.0 * np.pi * n / (length - 1)
    return 0.426591 - 0.496561 * np.cos(x) + 0.076848 * np.cos(2 * x)


def blackman_harris_4(length: int) -> np.ndarray:
    n = _n(length)
    x = 2.0 * np.pi * n / (length - 1)
    return (0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x)
            - 0.01168 * np.cos(3 * x))


def blackman_harris_7(length: int) -> np.ndarray:
    # 7-term Blackman-Harris (max sidelobe ~ -180 dB)
    a = [0.27105140069342, -0.43329793923448, 0.21812299954311,
         -0.06592544638803, 0.01081174209837, -0.00077658482522,
         0.00001388721735]
    n = _n(length)
    x = 2.0 * np.pi * n / (length - 1)
    w = np.zeros(length, dtype=np.float64)
    for k, ak in enumerate(a):
        w += ak * np.cos(k * x)
    return w


def flat_top(length: int) -> np.ndarray:
    a = [0.215578948, -0.41663158, 0.277263158, -0.083578947, 0.006947368]
    n = _n(length)
    x = 2.0 * np.pi * n / (length - 1)
    w = np.zeros(length, dtype=np.float64)
    for k, ak in enumerate(a):
        w += ak * np.cos(k * x)
    return w


def kaiser_beta(attenuation_db: float) -> float:
    """Kaiser window shape parameter for a target stop-band attenuation.

    Standard Kaiser empirical formula (same one the reference uses,
    dsp/filter/Window.java:343 getKaiserBeta).
    """
    a = float(attenuation_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def _i0(x: np.ndarray) -> np.ndarray:
    """Zeroth-order modified Bessel function of the first kind (series)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.ones_like(x)
    term = np.ones_like(x)
    half_x = x / 2.0
    for k in range(1, 64):
        term = term * (half_x / k) ** 2
        out = out + term
        if np.all(term < 1e-21 * out):
            break
    return out


def kaiser(length: int, attenuation_db: float = 80.0) -> np.ndarray:
    """Kaiser window sized by target attenuation (Window.java:366 getKaiser)."""
    beta = kaiser_beta(attenuation_db)
    n = _n(length)
    m = length - 1.0
    arg = beta * np.sqrt(1.0 - ((2.0 * n - m) / m) ** 2)
    return _i0(arg) / _i0(np.asarray(beta))


_WINDOWS = {
    "rectangular": rectangular,
    "hann": hann,
    "hanning": hann,
    "hamming": hamming,
    "cosine": cosine,
    "blackman": blackman,
    "blackman_harris_4": blackman_harris_4,
    "blackman_harris_7": blackman_harris_7,
    "flat_top": flat_top,
}


def get_window(name: str, length: int, attenuation_db: float = 80.0) -> np.ndarray:
    name = name.lower()
    if name == "kaiser":
        return kaiser(length, attenuation_db)
    try:
        return _WINDOWS[name](length)
    except KeyError:
        raise ValueError(f"unknown window type: {name}") from None
