"""File-replay sources: IQ recordings exposed as tuners / controllable files.

Equivalents of the reference's RecordingTunerController
(source/tuner/recording/RecordingTunerController.java:38 — replays an IQ
wave as if it were hardware) and ComplexWaveSource
(source/wave/ComplexWaveSource.java:47 — frame-steppable file source used
by the instrumentation viewers). Reference-format IQ .wav recordings are
this framework's golden test vectors.
"""
from __future__ import annotations

import numpy as np

from ..io import wave
from .tuner import TunerController, TunerSpec

__all__ = ["RecordingTuner", "ComplexWaveSource"]


class RecordingTuner(TunerController):
    """Replays a complex IQ wave file as a tuner; optionally loops."""

    def __init__(self, path, center_frequency: float = 450e6,
                 loop: bool = False):
        iq, rate = wave.read_complex_wave(path)
        spec = TunerSpec(
            name=f"recording:{path}",
            minimum_frequency=0.0,
            maximum_frequency=10e9,
            sample_rates=(float(rate),),
            usable_fraction=1.0,
            dc_spike_hz=0.0,
        )
        super().__init__(spec, frequency=center_frequency,
                         sample_rate=float(rate))
        self._iq = np.asarray(iq, dtype=np.complex64)
        self._pos = 0
        self.loop = loop

    def _read_chunk(self, num_samples: int) -> np.ndarray | None:
        if self._pos >= len(self._iq):
            if not self.loop:
                return None
            self._pos = 0
        if not self.loop:
            chunk = self._iq[self._pos: self._pos + num_samples]
            self._pos += len(chunk)
            return chunk
        # loop mode: always return exactly num_samples, wrapping across EOF
        # so fixed-block consumers (JIT pipelines) see constant chunk sizes
        pieces = []
        need = num_samples
        while need > 0:
            take = self._iq[self._pos: self._pos + need]
            if len(take) == 0:
                self._pos = 0
                continue
            pieces.append(take)
            self._pos += len(take)
            need -= len(take)
            if self._pos >= len(self._iq):
                self._pos = 0
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)


class ComplexWaveSource:
    """Frame-steppable IQ file source for instrumented debugging.

    next(n) returns the next n samples (or fewer at EOF); rewind() restarts.
    Mirrors IControllableFileSource stepping (source/wave/ComplexWaveSource
    .java:141,244) without the 20 fps scheduler — callers pull at will.
    """

    def __init__(self, path):
        self.iq, self.sample_rate = wave.read_complex_wave(path)
        self.iq = np.asarray(self.iq, dtype=np.complex64)
        self._pos = 0

    def __len__(self) -> int:
        return len(self.iq)

    @property
    def position(self) -> int:
        return self._pos

    def next(self, num_samples: int) -> np.ndarray:
        chunk = self.iq[self._pos: self._pos + num_samples]
        self._pos += len(chunk)
        return chunk

    def rewind(self) -> None:
        self._pos = 0
