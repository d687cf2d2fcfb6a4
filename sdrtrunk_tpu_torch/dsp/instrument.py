"""Instrumentation taps: eye diagram, constellation, symbol/PLL traces.

Plays the role of the reference's instrumented-decoder tap system
(dsp/symbol/ISymbolDecisionProcessor + the EyeDiagram / constellation
viewer taps in gui/instrument): cold-path, host-side analysis arrays
derived from the channel baseband and decoder outputs, suitable for
JSONL/npz export from the headless CLI.  Unlike the reference (Swing
panels), the tap output here IS the product: arrays + summary metrics.
"""
from __future__ import annotations

import numpy as np

__all__ = ["eye_diagram", "eye_opening", "best_eye", "integrate_and_dump",
           "dqpsk_constellation", "constellation_metrics",
           "fsk_symbol_trace"]


def integrate_and_dump(trace: np.ndarray,
                       samples_per_symbol: float) -> np.ndarray:
    """Boxcar average over one symbol period — the C4FM symbol filter
    that precedes decisions (the modulator's shaping is deliberately
    not zero-ISI until this receive filter is applied)."""
    n = max(1, int(samples_per_symbol))
    kernel = np.ones(n) / n
    return np.convolve(np.asarray(trace, np.float64).ravel(), kernel,
                       mode="same")


def eye_diagram(trace: np.ndarray, samples_per_symbol: float,
                span_symbols: int = 2, max_traces: int = 200,
                offset: float = 0.0) -> np.ndarray:
    """Slice a demodulated trace into overlaid eye traces.

    Returns (n_traces, span) real array; span = span_symbols * sps
    rounded to ints with per-trace fractional-period resampling so
    non-integer symbol rates (e.g. 25 kHz / 4800 baud = 5.208 sps)
    stay aligned.
    """
    x = np.asarray(trace, np.float64).ravel()
    sps = float(samples_per_symbol)
    span = int(round(span_symbols * sps))
    if span < 2 or len(x) < span + int(sps):
        return np.zeros((0, max(span, 2)))
    n_traces = min(max_traces,
                   int((len(x) - span) / (span_symbols * sps)))
    out = np.empty((n_traces, span))
    for i in range(n_traces):
        start = offset + i * span_symbols * sps
        idx = start + np.arange(span)
        i0 = np.floor(idx).astype(np.int64)
        frac = idx - i0
        i0 = np.clip(i0, 0, len(x) - 2)
        out[i] = x[i0] * (1 - frac) + x[i0 + 1] * frac
    return out


def eye_opening(eye: np.ndarray, levels=(-3.0, -1.0, 1.0, 3.0),
                window: float = 0.25) -> float:
    """Vertical eye opening at the symbol-decision instant, normalised
    by the level spacing: 1.0 = ideal, <=0 = closed.

    Measures the worst-case gap between adjacent level clusters using
    samples within +/- window/2 of the trace midpoint.
    """
    if eye.size == 0:
        return 0.0
    mid = eye.shape[1] // 2
    half = max(1, int(eye.shape[1] * window / 2))
    levels = np.sort(np.asarray(levels, np.float64))
    spacing = np.min(np.diff(levels))
    best = -1.0
    # the eye is widest at exactly one instant — evaluate each column
    # near the centre and keep the best (a window-average would mix
    # inter-symbol transition samples into the clusters)
    for col in range(max(0, mid - half),
                     min(eye.shape[1], mid + half + 1)):
        samples = eye[:, col]
        assign = np.argmin(np.abs(samples[:, None] - levels[None, :]),
                           axis=1)
        worst = np.inf
        for a, b in zip(range(len(levels) - 1), range(1, len(levels))):
            lo = samples[assign == a]
            hi = samples[assign == b]
            if len(lo) == 0 or len(hi) == 0:
                continue
            worst = min(worst, (hi.min() - lo.max()) / spacing)
        if worst is not np.inf:
            best = max(best, float(worst))
    return max(-1.0, min(1.0, best)) if best > -1.0 else 0.0


def best_eye(trace: np.ndarray, samples_per_symbol: float,
             levels=(-3.0, -1.0, 1.0, 3.0), scale: float | None = None,
             span_symbols: int = 2, max_traces: int = 200,
             symbol_filter: bool = True
             ) -> tuple[np.ndarray, float, float]:
    """Search the symbol-clock phase for the widest eye — the trigger
    alignment a hardware eye diagram gets from its recovered clock.

    Returns (eye, offset, opening); `scale` normalises the trace to the
    level grid (default: 98th-percentile |trace| mapped to the outer
    level).
    """
    x = np.asarray(trace, np.float64).ravel()
    if symbol_filter:
        x = integrate_and_dump(x, samples_per_symbol)
    sps = float(samples_per_symbol)
    if scale is None:
        # the shaped waveform overshoots between symbols (deliberate in
        # C4FM), so a percentile of the whole trace overestimates —
        # estimate the level grid from the decision-instant clusters at
        # the best-clustering clock phase instead
        outer = max(abs(l) for l in levels)
        best_err, scale = np.inf, 1.0
        for t0 in np.arange(0.0, sps, max(sps / 16.0, 0.25)):
            sym = fsk_symbol_trace(x, sps, offset=t0)
            a = np.abs(sym)
            med = np.median(a)
            hi = a[a >= med]
            cand = np.median(hi) / outer if len(hi) else 1.0
            if cand <= 0:
                continue
            q = sym / cand
            err = np.mean(np.abs(q - np.round(q)))
            if err < best_err:
                best_err, scale = err, cand
    best = (np.zeros((0, 2)), 0.0, -1.0)
    for offset in np.arange(0.0, sps, max(sps / 16.0, 0.25)):
        eye = eye_diagram(x, sps, span_symbols, max_traces, offset)
        opening = eye_opening(eye / scale, levels)
        if opening > best[2]:
            best = (eye, float(offset), opening)
    return best


def dqpsk_constellation(iq: np.ndarray, samples_per_symbol: float,
                        offset: float = 0.0,
                        max_points: int = 2000) -> np.ndarray:
    """Differential-phase constellation from channel baseband.

    Samples the complex baseband at symbol instants and forms
    z[k] * conj(z[k-1]) normalised — DQPSK decisions cluster at
    +/-45 and +/-135 degrees, matching what the reference's
    constellation viewer shows for its PSK demodulators.
    """
    x = np.asarray(iq, np.complex128).ravel()
    sps = float(samples_per_symbol)
    n_sym = int((len(x) - 1) / sps) - 1
    n_sym = min(n_sym, max_points + 1)
    if n_sym < 2:
        return np.zeros(0, np.complex128)
    idx = offset + np.arange(n_sym) * sps
    i0 = np.floor(idx).astype(np.int64)
    frac = idx - i0
    i0 = np.clip(i0, 0, len(x) - 2)
    sym = x[i0] * (1 - frac) + x[i0 + 1] * frac
    d = sym[1:] * np.conj(sym[:-1])
    mag = np.abs(d)
    mag[mag < 1e-12] = 1.0
    return d / mag


def constellation_metrics(points: np.ndarray) -> dict:
    """Cluster the differential constellation onto the four DQPSK
    decision angles; returns cluster occupancy and RMS error-vector
    magnitude in degrees."""
    if len(points) == 0:
        return {"points": 0, "evm_deg": None, "occupancy": [0, 0, 0, 0]}
    ang = np.angle(points, deg=True)
    targets = np.array([45.0, 135.0, -135.0, -45.0])
    err = np.abs(((ang[:, None] - targets[None, :]) + 180) % 360 - 180)
    nearest = np.argmin(err, axis=1)
    evm = float(np.sqrt(np.mean(err[np.arange(len(ang)), nearest] ** 2)))
    occ = [int(np.sum(nearest == k)) for k in range(4)]
    return {"points": int(len(points)), "evm_deg": round(evm, 2),
            "occupancy": occ}


def fsk_symbol_trace(audio: np.ndarray, samples_per_symbol: float,
                     offset: float = 0.0, max_points: int = 4000
                     ) -> np.ndarray:
    """Symbol-instant amplitude trace for FSK/C4FM decision debugging
    (the reference's symbol viewer tap)."""
    x = np.asarray(audio, np.float64).ravel()
    sps = float(samples_per_symbol)
    n = min(int((len(x) - 1) / sps), max_points)
    idx = offset + np.arange(n) * sps
    i0 = np.floor(idx).astype(np.int64)
    frac = idx - i0
    i0 = np.clip(i0, 0, len(x) - 2)
    return x[i0] * (1 - frac) + x[i0 + 1] * frac
