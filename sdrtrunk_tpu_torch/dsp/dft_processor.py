"""Streaming frame-rate DFT processor — the data engine behind the
spectral/waterfall display (spectrum/DFTProcessor.java:48,213).

The reference runs a scheduled task at a configurable frame rate
(default 20 fps, "spectral.display.frame.rate"), consumes
sampleRate/frameRate samples per tick from an overflowable stream,
windows (Hann default) and FFTs them, and dispatches the frame to
converters; when the per-tick consumption is smaller than the FFT size
it OVERLAPS (re-reads the tail of the previous frame), and when larger
it FLUSHES the excess. This is the sample-clock-deterministic version:
feed IQ with `receive`, get back every frame the configured rate
produces (no wall-clock scheduler — frames are a pure function of the
stream, so replay is exact).
"""
from __future__ import annotations

import numpy as np

from . import windows as _windows

__all__ = ["DFTProcessor", "waterfall"]


class DFTProcessor:
    """Frame-rate windowed DFT over a streaming IQ (or real) signal.

    Each frame is the FFT of `fft_size` samples ending at the frame's
    consumption point, Hann-windowed, returned as dB magnitudes with DC
    centered for complex input. Frame cadence: sample_rate / frame_rate
    samples per frame (DFTProcessor.calculateConsumptionRate).
    """

    def __init__(self, sample_rate: float, fft_size: int = 4096,
                 frame_rate: float = 20.0, window: str = "hann",
                 complex_input: bool = True):
        if not 1 <= frame_rate <= 1000:
            raise ValueError("frame rate must be within 1..1000 "
                             "(DFTProcessor.setFrameRate bounds)")
        self.sample_rate = float(sample_rate)
        self.fft_size = int(fft_size)
        self.frame_rate = float(frame_rate)
        self.complex_input = complex_input
        self._window = _windows.get_window(window, self.fft_size)
        self._frame_samples = max(1, int(self.sample_rate / frame_rate))
        dtype = np.complex64 if complex_input else np.float32
        self._buffer = np.zeros(0, dtype)
        self._consumed = 0

    # --- source events (ISourceEventProcessor role) --------------------

    def set_sample_rate(self, sample_rate: float) -> None:
        self.sample_rate = float(sample_rate)
        self._frame_samples = max(1, int(sample_rate / self.frame_rate))

    def set_frame_rate(self, frame_rate: float) -> None:
        if not 1 <= frame_rate <= 1000:
            raise ValueError("frame rate must be within 1..1000")
        self.frame_rate = float(frame_rate)
        self._frame_samples = max(1, int(self.sample_rate / frame_rate))

    # --- streaming -----------------------------------------------------

    def receive(self, x: np.ndarray) -> np.ndarray:
        """Feed samples; returns (frames, fft_size) dB magnitudes for
        every frame completed by this chunk (possibly zero)."""
        x = np.asarray(x)
        self._buffer = np.concatenate([self._buffer, x.astype(
            self._buffer.dtype)])
        frames = []
        # a frame fires each time `frame_samples` more samples arrive;
        # the FFT window is the trailing fft_size samples at that point
        # (shorter history zero-pads on the left, like the reference's
        # stream priming)
        while len(self._buffer) - self._consumed >= self._frame_samples:
            self._consumed += self._frame_samples
            start = self._consumed - self.fft_size
            if start < 0:
                seg = np.concatenate([
                    np.zeros(-start, self._buffer.dtype),
                    self._buffer[:self._consumed]])
            else:
                seg = self._buffer[start:self._consumed]
            frames.append(self._transform(seg))
        # drop history no future window can reach
        keep_from = max(0, self._consumed - self.fft_size)
        self._buffer = self._buffer[keep_from:]
        self._consumed -= keep_from
        if not frames:
            return np.zeros((0, self._bins()), np.float32)
        return np.stack(frames)

    def _bins(self) -> int:
        return self.fft_size if self.complex_input else self.fft_size // 2

    def _transform(self, seg: np.ndarray) -> np.ndarray:
        w = seg * self._window
        if self.complex_input:
            spec = np.fft.fftshift(np.fft.fft(w))
        else:
            spec = np.fft.rfft(w)[:self.fft_size // 2]
        mag = np.abs(spec) / self.fft_size
        return (20.0 * np.log10(np.maximum(mag, 1e-12))).astype(np.float32)


def waterfall(x: np.ndarray, sample_rate: float, fft_size: int = 1024,
              frame_rate: float = 20.0) -> np.ndarray:
    """One-shot waterfall: (frames, fft_size) dB rows for a capture."""
    proc = DFTProcessor(sample_rate, fft_size=fft_size,
                        frame_rate=frame_rate,
                        complex_input=np.iscomplexobj(x))
    return proc.receive(x)
