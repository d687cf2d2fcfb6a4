"""Synthetic test tuner: tone + optional sweep generator backend.

Equivalent of the reference's fake SDR used for channelizer/e2e testing
(source/tuner/test/TestTunerController.java:29 — 10 MS/s synthetic, and
SampleGenerator.java — oscillator tone with optional frequency sweep that
resets after exceeding the usable range).
"""
from __future__ import annotations

import numpy as np

from .tuner import TunerController, TunerSpec

__all__ = ["TestTuner"]

_SPEC = TunerSpec(
    name="test",
    minimum_frequency=1e6,
    maximum_frequency=3e9,
    sample_rates=(10_000_000.0, 2_400_000.0, 400_000.0),
    usable_fraction=1.0,
    dc_spike_hz=0.0,
)


class TestTuner(TunerController):
    """Generates a unit tone at `tone_offset_hz` from center, optionally
    sweeping by `sweep_rate_hz` per chunk (wrapping at +Nyquist/2)."""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, sample_rate: float = 10_000_000.0,
                 frequency: float = 450_000_000.0,
                 tone_offset_hz: float = 25_000.0,
                 sweep_rate_hz: float = 0.0,
                 amplitude: float = 0.5,
                 total_samples: int | None = None):
        super().__init__(_SPEC, frequency=frequency, sample_rate=sample_rate)
        self.tone_offset_hz = tone_offset_hz
        self.sweep_rate_hz = sweep_rate_hz
        self.amplitude = amplitude
        self.total_samples = total_samples
        self._phase = 0.0
        self._emitted = 0

    def _read_chunk(self, num_samples: int) -> np.ndarray | None:
        if self.total_samples is not None:
            remaining = self.total_samples - self._emitted
            if remaining <= 0:
                return None
            num_samples = min(num_samples, remaining)
        step = 2.0 * np.pi * self.tone_offset_hz / self._sample_rate
        angles = self._phase + step * np.arange(num_samples)
        chunk = (self.amplitude * np.exp(1j * angles)).astype(np.complex64)
        self._phase = float((self._phase + step * num_samples)
                            % (2.0 * np.pi))
        self._emitted += num_samples
        if self.sweep_rate_hz:
            self.tone_offset_hz += self.sweep_rate_hz
            if abs(self.tone_offset_hz) >= self._sample_rate / 4:
                self.tone_offset_hz = 1.0  # reset like SampleGenerator
        return chunk
