"""Synthetic signal generators (host-side NumPy test fixtures).

The reference ships only a tone/sweep generator for its fake tuner backend
(source/tuner/test/SampleGenerator.java); it has no modulators because it only
receives. We need closed-loop self-tests, so this module also provides NBFM,
C4FM (P25 Phase 1), 4FSK (DMR), and sub-audible FSK (LTR) modulators.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "tone", "sweep", "awgn", "nbfm_modulate", "fm_modulate",
    "c4fm_modulate", "dibits_to_symbols", "random_dibits",
    "raised_cosine", "root_raised_cosine", "lsm_modulate",
    "afsk1200_modulate",
]

TWO_PI = 2.0 * np.pi

# P25 C4FM dibit -> symbol level (units of +/-1, +/-3), TIA-102.BAAA.
# Matches the reference's Dibit enum (dsp/symbol/Dibit.java):
#   00 -> +1 (+600 Hz), 01 -> +3 (+1800 Hz), 10 -> -1, 11 -> -3
C4FM_DIBIT_TO_LEVEL = np.array([1.0, 3.0, -1.0, -3.0])
C4FM_DEVIATION_HZ = 600.0  # deviation per symbol unit


def tone(frequency: float, sample_rate: float, num_samples: int,
         amplitude: float = 1.0, phase: float = 0.0) -> np.ndarray:
    """Complex tone at `frequency` Hz (the reference SampleGenerator's mode)."""
    t = np.arange(num_samples, dtype=np.float64)
    return (amplitude * np.exp(1j * (TWO_PI * frequency / sample_rate * t + phase))
            ).astype(np.complex64)


def sweep(start_hz: float, stop_hz: float, sample_rate: float,
          num_samples: int, amplitude: float = 1.0) -> np.ndarray:
    """Linear frequency sweep (SampleGenerator's sweep mode)."""
    t = np.arange(num_samples, dtype=np.float64) / sample_rate
    duration = num_samples / sample_rate
    k = (stop_hz - start_hz) / duration
    phase = TWO_PI * (start_hz * t + 0.5 * k * t * t)
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)


def awgn(x: np.ndarray, snr_db: float, rng=None) -> np.ndarray:
    """Add complex white Gaussian noise at the given SNR."""
    rng = rng or np.random.default_rng(0)
    power = np.mean(np.abs(x) ** 2)
    noise_power = power / (10.0 ** (snr_db / 10.0))
    sigma = np.sqrt(noise_power / 2.0)
    noise = sigma * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    return (x + noise).astype(np.complex64)


def fm_modulate(message: np.ndarray, deviation_hz: float,
                sample_rate: float, amplitude: float = 1.0) -> np.ndarray:
    """FM-modulate a real message (|message| <= 1) to complex baseband.

    Phase is accumulated trapezoidally — a plain cumsum (left Riemann sum)
    adds O(f_dot/fs) phase jitter that shows up as differential-phase ISI
    in symbol-recovery tests.
    """
    m = np.asarray(message, np.float64)
    mid = np.concatenate([[m[0]], 0.5 * (m[1:] + m[:-1])])
    phase = TWO_PI * deviation_hz / sample_rate * np.cumsum(mid)
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)


def nbfm_modulate(audio: np.ndarray, audio_rate: float, sample_rate: float,
                  deviation_hz: float = 3000.0, amplitude: float = 1.0) -> np.ndarray:
    """Narrowband FM: upsample audio to `sample_rate` and FM modulate."""
    n_out = int(round(len(audio) * sample_rate / audio_rate))
    t_out = np.arange(n_out) * (audio_rate / sample_rate)
    message = np.interp(t_out, np.arange(len(audio), dtype=np.float64),
                        np.asarray(audio, np.float64))
    return fm_modulate(message, deviation_hz, sample_rate, amplitude)


def raised_cosine(sps: float, span_symbols: int, alpha: float = 0.2) -> np.ndarray:
    """Raised-cosine pulse (unit peak), sampled at `sps` samples/symbol."""
    n = int(round(span_symbols * sps)) | 1
    t = (np.arange(n) - n // 2) / sps
    eps = 1e-9
    denom = 1.0 - (2.0 * alpha * t) ** 2
    h = np.sinc(t) * np.cos(np.pi * alpha * t) / np.where(np.abs(denom) < eps, eps, denom)
    # L'Hopital at the denominator zeros t = +/- 1/(2 alpha)
    zero_idx = np.abs(denom) < eps
    h[zero_idx] = (np.pi / 4.0) * np.sinc(1.0 / (2.0 * alpha))
    return h


def root_raised_cosine(sps: float, span_symbols: int, alpha: float = 0.2) -> np.ndarray:
    """Root-raised-cosine pulse, unit energy-ish (normalized peak)."""
    n = int(round(span_symbols * sps)) | 1
    t = (np.arange(n) - n // 2) / sps
    h = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - alpha + 4.0 * alpha / np.pi
        elif abs(abs(4.0 * alpha * ti) - 1.0) < 1e-9:
            h[i] = (alpha / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha)))
        else:
            h[i] = (np.sin(np.pi * ti * (1.0 - alpha))
                    + 4.0 * alpha * ti * np.cos(np.pi * ti * (1.0 + alpha))) / (
                np.pi * ti * (1.0 - (4.0 * alpha * ti) ** 2))
    return h / np.max(h)


def _shape_pulse_train(levels: np.ndarray, sps: float, n: int,
                       span_symbols: int, alpha: float,
                       pulse_fn=None) -> np.ndarray:
    """Sum of raised-cosine pulses at EXACT fractional symbol positions.

    message[i] = sum_k levels[k] * rc((i - k*sps)/sps). Evaluating the pulse
    at the true fractional offsets (instead of rounding each symbol to the
    nearest sample) keeps the modulator free of timing jitter so closed-loop
    symbol-recovery tests can demand BER = 0.
    """
    levels = np.asarray(levels, np.complex128 if np.iscomplexobj(levels)
                        else np.float64)
    half = span_symbols / 2.0
    i = np.arange(n, dtype=np.float64)
    out = np.zeros(n, dtype=levels.dtype)
    if pulse_fn is None:
        def pulse_fn(t):
            eps = 1e-9
            denom = 1.0 - (2.0 * alpha * t) ** 2
            h = np.sinc(t) * np.cos(np.pi * alpha * t) / np.where(
                np.abs(denom) < eps, eps, denom)
            h = np.where(np.abs(denom) < eps,
                         (np.pi / 4.0) * np.sinc(1.0 / (2.0 * alpha)), h)
            return np.where(np.abs(t) <= half, h, 0.0)
    # chunk over symbols; each pulse only spans `span_symbols`, so evaluate
    # the (samples, chunk) matrix over the chunk's support window only —
    # O(n·span) total work instead of O(n·num_symbols)
    for k0 in range(0, len(levels), 256):
        k1 = min(k0 + 256, len(levels))
        k = np.arange(k0, k1, dtype=np.float64)
        lo = max(0, int(np.floor((k0 - half) * sps)))
        hi = min(n, int(np.ceil((k1 - 1 + half) * sps)) + 1)
        t = (i[lo:hi, None] - k[None, :] * sps) / sps  # symbol units
        out[lo:hi] += pulse_fn(t) @ levels[k0:k1]
    return out


def _c4fm_pulse(alpha: float = 0.2, span_symbols: int = 12,
                res: int = 64):
    """C4FM frequency-pulse sampled on a fine grid (symbol units).

    TIA-102.BAAA defines the C4FM modulation filter as a Nyquist raised
    cosine CASCADED with the shaping filter P(f) = (pi f T) / sin(pi f T)
    — the inverse of the receiver's integrate-over-a-symbol (differential
    phase) response. With this pre-compensation the phase CHANGE across
    each symbol period is exactly +/-45 or +/-135 degrees even for
    alternating +/-3 runs (e.g. sync patterns); a plain RC pulse
    compresses alternating-run differential phases by ~35%.

    Returns (grid_t, values) with grid_t in symbol units; values
    normalized so a pulse train sums to 1 at any instant for an all-ones
    symbol stream.
    """
    # frequency grid over the RC support
    T = 1.0
    fmax = (1.0 + alpha) / (2.0 * T)
    f = np.linspace(0.0, fmax, 2048)
    # raised cosine spectrum (unit DC)
    h = np.ones_like(f)
    f1 = (1.0 - alpha) / (2.0 * T)
    roll = (f > f1)
    h[roll] = 0.5 * (1.0 + np.cos(np.pi * T / alpha * (f[roll] - f1)))
    # inverse-sinc shaping: P(f) = (pi f T) / sin(pi f T)
    x = np.maximum(np.pi * f * T, 1e-12)
    shaping = x / np.sin(np.minimum(x, np.pi - 1e-9))
    shaping[0] = 1.0
    H = h * shaping
    # time domain on a fine grid via cosine transform
    tgrid = np.arange(-span_symbols / 2 * res,
                      span_symbols / 2 * res + 1) / res
    p = 2.0 * np.trapezoid(H[None, :] * np.cos(
        2.0 * np.pi * tgrid[:, None] * f[None, :]), f, axis=1)
    p *= T  # unit DC gain of the pulse train
    return tgrid, p


_C4FM_PULSE_CACHE: dict = {}


def random_dibits(count: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, size=count).astype(np.int32)


def dibits_to_symbols(dibits: np.ndarray,
                      mapping: np.ndarray = C4FM_DIBIT_TO_LEVEL) -> np.ndarray:
    return mapping[np.asarray(dibits, np.int64)]


def c4fm_modulate(dibits: np.ndarray, sample_rate: float,
                  symbol_rate: float = 4800.0, alpha: float = 0.2,
                  span_symbols: int = 12, amplitude: float = 1.0) -> np.ndarray:
    """P25 Phase-1 C4FM modulator.

    4-level FSK at `symbol_rate` baud: dibits map to +/-1, +/-3 symbol units of
    600 Hz deviation each, pulse-shaped with a raised cosine, then frequency
    modulated. The differential phase per symbol is +/-pi/4 (+/-600 Hz) or
    +/-3pi/4 (+/-1800 Hz), which is what the reference's decision-directed
    DQPSK demodulator slices (dsp/psk/DQPSKDecisionDirectedSymbolEvaluator.java).
    """
    sps = sample_rate / symbol_rate
    levels = dibits_to_symbols(dibits)
    n = int(np.ceil(len(levels) * sps)) + int(np.ceil(span_symbols * sps))
    key = (alpha, span_symbols)
    if key not in _C4FM_PULSE_CACHE:
        _C4FM_PULSE_CACHE[key] = _c4fm_pulse(alpha, span_symbols)
    tgrid, pvals = _C4FM_PULSE_CACHE[key]

    def pulse_fn(t):
        return np.interp(t, tgrid, pvals, left=0.0, right=0.0)

    message = _shape_pulse_train(levels, sps, n, span_symbols, alpha,
                                 pulse_fn=pulse_fn)
    return fm_modulate(message, C4FM_DEVIATION_HZ, sample_rate, amplitude)


def lsm_modulate(dibits: np.ndarray, sample_rate: float,
                 symbol_rate: float = 4800.0, alpha: float = 0.2,
                 span_symbols: int = 12, amplitude: float = 1.0) -> np.ndarray:
    """pi/4-DQPSK (LSM / CQPSK-style) modulator for P25 simulcast tests.

    Differential phase steps of +/-pi/4, +/-3pi/4 with RRC shaping of the
    linear (not FM) constellation.
    """
    phase_step = np.array([np.pi / 4, 3 * np.pi / 4, -np.pi / 4, -3 * np.pi / 4])
    steps = phase_step[np.asarray(dibits, np.int64)]
    phases = np.cumsum(steps)
    symbols = np.exp(1j * phases)
    sps = sample_rate / symbol_rate
    n = int(np.ceil(len(symbols) * sps)) + int(np.ceil(span_symbols * sps))

    def rrc(t):
        h = np.zeros_like(t)
        near0 = np.abs(t) < 1e-9
        sing = np.abs(np.abs(4.0 * alpha * t) - 1.0) < 1e-9
        rest = ~(near0 | sing)
        tr = t[rest]
        h[near0] = 1.0 - alpha + 4.0 * alpha / np.pi
        h[sing] = (alpha / np.sqrt(2.0)) * (
            (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
            + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha)))
        h[rest] = (np.sin(np.pi * tr * (1.0 - alpha))
                   + 4.0 * alpha * tr * np.cos(np.pi * tr * (1.0 + alpha))) / (
            np.pi * tr * (1.0 - (4.0 * alpha * tr) ** 2))
        return np.where(np.abs(t) <= span_symbols / 2.0, h, 0.0)

    x = _shape_pulse_train(symbols, sps, n, span_symbols, alpha, pulse_fn=rrc)
    peak = np.max(np.abs(x))
    return (amplitude * x / peak).astype(np.complex64)


def afsk1200_modulate(bits: np.ndarray, sample_rate: float = 8000.0,
                      baud: float = 1200.0, mark_hz: float = 1200.0,
                      space_hz: float = 1800.0,
                      amplitude: float = 0.5) -> np.ndarray:
    """Phase-continuous audio FSK: bit 1 -> mark tone, 0 -> space tone.

    Test-vector source for the AFSK protocols (MPT1327, Fleetsync II,
    MDC-1200, LJ-1200, Tait 1200); the reference has no modulators, so
    closed-loop tests synthesize their own (SURVEY.md section 4).
    """
    bits = np.asarray(bits)
    sps = sample_rate / baud
    n = int(np.ceil(len(bits) * sps))
    t = np.arange(n)
    sym = np.minimum((t / sps).astype(np.int64), len(bits) - 1)
    freq = np.where(bits[sym] == 1, mark_hz, space_hz)
    phase = TWO_PI * np.cumsum(freq) / sample_rate
    return (amplitude * np.sin(phase)).astype(np.float32)
