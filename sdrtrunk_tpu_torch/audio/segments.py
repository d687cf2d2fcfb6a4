"""Audio segments: growing PCM buffers with identifier tracking (role of
audio/AudioSegment.java:64 — minus the ref-counting, which functional
arrays make unnecessary, SURVEY.md section 5 race-detection note).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..runtime.identifiers import IdentifierCollection

__all__ = ["AudioSegment"]


@dataclass
class AudioSegment:
    sample_rate: float = 8000.0
    start_time: float = 0.0
    identifiers: IdentifierCollection = field(
        default_factory=IdentifierCollection)
    _chunks: list = field(default_factory=list)
    complete: bool = False
    duplicate: bool = False
    timeslot: int = 0
    # playback-manager fields (AudioSegment.java monitor properties)
    monitor_priority: int = 100
    do_not_monitor: bool = False
    linked_to: object = None        # prior segment of the same call

    def add_audio(self, pcm: np.ndarray) -> None:
        if self.complete:
            raise ValueError("segment already completed")
        self._chunks.append(np.asarray(pcm, np.float32))

    def add_identifiers(self, identifiers) -> None:
        self.identifiers.update_all(identifiers)

    def complete_segment(self) -> None:
        self.complete = True

    @property
    def samples(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(self._chunks)

    @property
    def duration(self) -> float:
        return sum(len(c) for c in self._chunks) / self.sample_rate

    @property
    def end_time(self) -> float:
        return self.start_time + self.duration
