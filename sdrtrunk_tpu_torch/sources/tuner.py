"""Tuner abstraction + manager: the control surface of layer L0.

Role of the reference's TunerController / TunerManager / TunerModel
(source/tuner/TunerController.java:42, source/tuner/TunerManager.java:53,
source/tuner/TunerModel.java): frequency/sample-rate/gain control, usable
bandwidth accounting (center dead zone for DC spike), source events, and a
registry that hands out IQ chunk iterators.

Hardware USB backends (RTL/Airspy/HackRF/FCD) require libusb and real
devices; this framework defines the controller contract plus the software
backends (TestTuner, RecordingTuner, wave files). A USB backend plugs in by
subclassing TunerController and producing raw buffers through
sources.converters — the ingest pipeline (io/native.py ring + receiver) is
backend-agnostic.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np

__all__ = ["SourceEventType", "SourceEvent", "TunerSpec", "TunerController",
           "TunerManager", "TunerUnavailable"]


class TunerUnavailable(RuntimeError):
    pass


class SourceEventType(enum.Enum):
    """Control/notification events (source/SourceEvent.java:33-67)."""
    # notifications
    FREQUENCY_CHANGE = "frequency_change"
    SAMPLE_RATE_CHANGE = "sample_rate_change"
    FREQUENCY_CORRECTION_CHANGE = "frequency_correction_change"
    ERROR_STATE = "error_state"
    OVERFLOW = "overflow"
    RECORDING_OVERRUN = "recording_overrun"
    STREAM_START = "stream_start"
    STREAM_STOP = "stream_stop"
    HEARTBEAT = "heartbeat"
    # requests
    REQUEST_FREQUENCY_CHANGE = "request_frequency_change"
    REQUEST_START_SAMPLE_STREAM = "request_start_sample_stream"
    REQUEST_STOP_SAMPLE_STREAM = "request_stop_sample_stream"


@dataclass(frozen=True)
class SourceEvent:
    type: SourceEventType
    value: float | None = None
    source: str | None = None


@dataclass
class TunerSpec:
    """Static capabilities of a tuner class.

    usable_fraction: total usable fraction of the sample rate, centered
    (TunerController's usable-bandwidth accounting; e.g. RTL ~0.95 total).
    dc_spike_hz: half-width of the unusable center region.
    """
    name: str
    minimum_frequency: float
    maximum_frequency: float
    sample_rates: tuple[float, ...]
    usable_fraction: float = 0.95
    dc_spike_hz: float = 5000.0


class TunerController:
    """Base controller: frequency/rate/gain state + event listeners +
    chunked IQ iteration. Subclasses implement _read_chunk()."""

    def __init__(self, spec: TunerSpec, frequency: float | None = None,
                 sample_rate: float | None = None):
        self.spec = spec
        self._frequency = frequency or spec.minimum_frequency
        self._sample_rate = sample_rate or spec.sample_rates[0]
        self._ppm = 0.0
        self._listeners: list[Callable[[SourceEvent], None]] = []
        self._running = False

    # -- events ------------------------------------------------------------
    def add_listener(self, fn: Callable[[SourceEvent], None]) -> None:
        self._listeners.append(fn)

    def _broadcast(self, event: SourceEvent) -> None:
        for fn in list(self._listeners):
            fn(event)

    # -- control -----------------------------------------------------------
    @property
    def frequency(self) -> float:
        return self._frequency

    @frequency.setter
    def frequency(self, hz: float) -> None:
        if not (self.spec.minimum_frequency <= hz <= self.spec.maximum_frequency):
            raise ValueError(
                f"{hz} Hz outside [{self.spec.minimum_frequency}, "
                f"{self.spec.maximum_frequency}] for {self.spec.name}")
        self._frequency = hz
        self._broadcast(SourceEvent(SourceEventType.FREQUENCY_CHANGE, hz,
                                    self.spec.name))

    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    @sample_rate.setter
    def sample_rate(self, rate: float) -> None:
        if rate not in self.spec.sample_rates:
            raise ValueError(f"rate {rate} unsupported by {self.spec.name}; "
                             f"choose from {self.spec.sample_rates}")
        self._sample_rate = rate
        self._broadcast(SourceEvent(SourceEventType.SAMPLE_RATE_CHANGE, rate,
                                    self.spec.name))

    @property
    def frequency_correction_ppm(self) -> float:
        return self._ppm

    @frequency_correction_ppm.setter
    def frequency_correction_ppm(self, ppm: float) -> None:
        self._ppm = ppm
        self._broadcast(SourceEvent(
            SourceEventType.FREQUENCY_CORRECTION_CHANGE, ppm, self.spec.name))

    # -- coverage ----------------------------------------------------------
    def usable_bandwidth(self) -> tuple[float, float]:
        """(min_hz, max_hz) absolute usable range at current tuning."""
        half = self._sample_rate * self.spec.usable_fraction / 2.0
        return self._frequency - half, self._frequency + half

    def covers(self, frequency: float, bandwidth: float) -> bool:
        lo, hi = self.usable_bandwidth()
        if not (lo <= frequency - bandwidth / 2
                and frequency + bandwidth / 2 <= hi):
            return False
        # channel may not straddle the DC spike
        return abs(frequency - self._frequency) > (self.spec.dc_spike_hz
                                                   + bandwidth / 2) \
            or self.spec.dc_spike_hz == 0.0

    # -- streaming ---------------------------------------------------------
    def _read_chunk(self, num_samples: int) -> np.ndarray | None:
        raise NotImplementedError

    def chunks(self, chunk_samples: int) -> Iterator[np.ndarray]:
        """Yield complex64 chunks until the backend is exhausted."""
        self._running = True
        self._broadcast(SourceEvent(SourceEventType.STREAM_START,
                                    source=self.spec.name))
        try:
            while self._running:
                chunk = self._read_chunk(chunk_samples)
                if chunk is None:
                    break
                yield chunk
        finally:
            self._running = False
            self._broadcast(SourceEvent(SourceEventType.STREAM_STOP,
                                        source=self.spec.name))

    def stop(self) -> None:
        self._running = False


@dataclass
class TunerManager:
    """Registry mapping names -> constructed tuners; picks one covering a
    requested channel (TunerModel.getSource semantics,
    source/tuner/TunerModel.java:420)."""
    tuners: dict[str, TunerController] = field(default_factory=dict)

    def add(self, name: str, tuner: TunerController) -> None:
        self.tuners[name] = tuner

    def source_for(self, frequency: float, bandwidth: float
                   ) -> TunerController:
        for tuner in self.tuners.values():
            if tuner.covers(frequency, bandwidth):
                return tuner
        raise TunerUnavailable(
            f"no tuner covers {frequency/1e6:.4f} MHz +/- {bandwidth/2:.0f} Hz")
