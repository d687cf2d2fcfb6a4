"""FIR filter design (host-side NumPy; runs once at graph-build time).

Covers the design surface of the reference's FilterFactory
(dsp/filter/FilterFactory.java): windowed-sinc low-pass, Kaiser-sinc,
half-band, the M/2 polyphase channelizer prototype search
(FilterFactory.java:808-925 getSincM2Channelizer), the synthesizer prototype
(FilterFactory.java:755 getSincM2Synthesizer), and equiripple (remez) low-pass
via scipy. All functions return float64 NumPy arrays; callers cast to the
device dtype.
"""
from __future__ import annotations

import numpy as np

from . import windows

__all__ = [
    "windowed_sinc", "kaiser_sinc", "evaluate_db", "sinc_m2_channelizer",
    "sinc_m2_synthesizer", "half_band", "remez_lowpass", "FilterDesignError",
    "PERFECT_RECONSTRUCTION_GAIN_DB",
]

# 20*log10(0.5): each of two adjacent channels contributes half amplitude at
# the shared band edge so that re-synthesis is gain-flat
# (FilterFactory.java:40).
PERFECT_RECONSTRUCTION_GAIN_DB = 20.0 * np.log10(0.5)
_MARGIN_DB = 0.0003  # FilterFactory.java:41


class FilterDesignError(ValueError):
    pass


def windowed_sinc(length: int, cutoff: float, window: str = "hamming",
                  attenuation_db: float = 80.0) -> np.ndarray:
    """Odd-length windowed-sinc low-pass filter.

    ``cutoff`` is in cycles/sample (0 < cutoff < 0.5). Matches the math of
    FilterFactory.getSinc (FilterFactory.java:931-958): coefficient k =
    2*cutoff*sinc(2*cutoff*(k-half)) * window[k].
    """
    if length % 2 == 0:
        raise FilterDesignError("windowed-sinc filters must be odd-length")
    half = length // 2
    n = np.arange(length, dtype=np.float64) - half
    taps = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    taps *= windows.get_window(window, length, attenuation_db)
    return taps


def kaiser_sinc(length: int, cutoff: float, attenuation_db: float = 80.0) -> np.ndarray:
    """Kaiser-windowed sinc (FilterFactory.java:970 getKaiserSinc)."""
    return windowed_sinc(length, cutoff, "kaiser", attenuation_db)


def evaluate_db(taps: np.ndarray, frequency: float) -> float:
    """Magnitude response in dB at a normalized frequency.

    ``frequency`` uses the reference's convention (FilterFactory.java:690
    evaluate): omega = pi * frequency, i.e. frequency=1.0 is Nyquist/1 ...
    actually 1.0 corresponds to omega=pi, so frequency is in units of
    (2*cycles/sample). A channel band edge at fs/(2M) is frequency = 1/M.
    """
    n = np.arange(len(taps), dtype=np.float64)
    z = np.sum(taps * np.exp(1j * np.pi * frequency * n))
    return float(10.0 * np.log10(z.real ** 2 + z.imag ** 2))


def _matches(response_db: float) -> bool:
    return abs(response_db - PERFECT_RECONSTRUCTION_GAIN_DB) <= _MARGIN_DB


def sinc_m2_channelizer(channel_bandwidth: float, channels: int,
                        taps_per_channel: int = 9) -> np.ndarray:
    """Design the M/2 polyphase channelizer prototype filter.

    Iteratively searches for the highest cutoff whose response at the channel
    band edge is -6.02 dB +/- 0.0003 dB (perfect reconstruction), escalating
    taps-per-channel up to +10 if the search fails — the same design
    objective and search schedule as the reference
    (FilterFactory.java:808-925 getSincM2Channelizer).

    Returns a filter of length exactly ``channels * actual_taps_per_channel``
    (odd-length design result pre-padded with one zero).
    """
    requested = taps_per_channel
    current = requested
    sample_rate = channel_bandwidth * channels
    band_edge = channel_bandwidth / sample_rate  # == 1/M in evaluate() units
    increment_threshold = 1.0 / sample_rate      # ~1 Hz resolution

    while True:
        length = channels * current - 1
        cutoff = band_edge / 2.0
        increment = cutoff * 0.1

        taps = kaiser_sinc(length, cutoff, 80.0)
        response = evaluate_db(taps, band_edge)
        failed = False

        while increment > increment_threshold:
            if _matches(response) and (cutoff + increment) <= band_edge:
                higher = kaiser_sinc(length, cutoff + increment, 80.0)
                higher_response = evaluate_db(higher, band_edge)
                if _matches(higher_response):
                    cutoff += increment
                    taps, response = higher, higher_response
                else:
                    increment /= 2.0
            elif _matches(response):
                increment /= 2.0
            else:
                cutoff -= increment
                if cutoff <= 0:
                    failed = True
                    break
                taps = kaiser_sinc(length, cutoff, 80.0)
                response = evaluate_db(taps, band_edge)

        if not failed and _matches(response):
            return np.concatenate([[0.0], taps])

        current += 1
        if current > requested + 10:
            raise FilterDesignError(
                f"cannot design M/2 channelizer: channels={channels} "
                f"bw={channel_bandwidth} taps/ch in [{requested},{requested + 10}]")


def sinc_m2_synthesizer(channel_sample_rate: float, channel_bandwidth: float,
                        channels: int, taps_per_channel: int) -> np.ndarray:
    """Prototype for the 2-channel polyphase synthesizer.

    Kaiser sinc at 105% of the channel bandwidth over the synthesizer's
    output rate (FilterFactory.java:755-770 getSincM2Synthesizer).
    """
    length = channels * taps_per_channel - 1
    cutoff = (channel_bandwidth * 1.10) / (channel_sample_rate * channels)
    taps = kaiser_sinc(length, cutoff, 80.0)
    return np.concatenate([[0.0], taps])


def half_band(order: int = 22, window: str = "blackman",
              attenuation_db: float = 80.0) -> np.ndarray:
    """Half-band low-pass (cutoff 0.25): every other tap is zero except center.

    Mirrors the role of FilterFactory.getHalfBand (FilterFactory.java:1007)
    used to build the x2..x1024 decimation cascades.
    """
    length = order + 1 if order % 2 == 0 else order
    if length % 2 == 0:
        length += 1
    taps = windowed_sinc(length, 0.25, window, attenuation_db)
    half = length // 2
    # Force exact half-band structure: odd-offset taps are exactly zero.
    for k in range(length):
        if k != half and (k - half) % 2 == 0:
            taps[k] = 0.0
    taps[half] = 0.5
    # Normalize DC gain to 1.
    taps = taps / np.sum(taps)
    return taps


def remez_lowpass(num_taps: int, pass_hz: float, stop_hz: float,
                  sample_rate: float, pass_ripple: float = 0.01,
                  stop_ripple: float = 0.01) -> np.ndarray:
    """Equiripple (Parks-McClellan) low-pass.

    Role of the reference's RemezFIRFilterDesigner
    (dsp/filter/fir/remez/RemezFIRFilterDesigner.java) used for decoder
    baseband filters (e.g. P25P1 pass 5100 / stop 6500 at 0.01 ripple,
    p25/phase1/P25P1DecoderC4FM.java getBasebandFilter). Uses scipy's remez;
    falls back to a Kaiser design if remez fails to converge.
    """
    from scipy import signal  # host-side only

    if num_taps % 2 == 0:
        num_taps += 1
    try:
        taps = signal.remez(
            num_taps,
            bands=[0.0, pass_hz, stop_hz, sample_rate / 2.0],
            desired=[1.0, 0.0],
            weight=[1.0 / pass_ripple, 1.0 / stop_ripple],
            fs=sample_rate,
        )
        if np.all(np.isfinite(taps)):
            return np.asarray(taps, dtype=np.float64)
    except Exception:
        pass
    # Kaiser fallback sized by the transition band.
    transition = (stop_hz - pass_hz) / sample_rate
    atten = 60.0
    length = max(num_taps, int(np.ceil((atten - 7.95) / (14.36 * transition))) | 1)
    if length % 2 == 0:
        length += 1
    cutoff = (pass_hz + stop_hz) / 2.0 / sample_rate
    return kaiser_sinc(length, cutoff, atten)
