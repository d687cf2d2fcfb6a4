"""Audio playback manager: priority assignment of audio segments to a
fixed set of output channels.

Mirrors audio/playback/AudioPlaybackManager.java:108-250: new segments
queue until they have audio; duplicate-suppressed segments are dropped;
linked segments follow their call onto the same output for continuity;
remaining segments sort by monitor priority, fill empty outputs first,
then preempt lower-priority playback.  The output device itself is a
pluggable sink (MonoAudioOutput.java's sourcedataline role) so the
manager is fully testable headless — bind a soundcard-backed sink in a
desktop deployment, a null/collector sink elsewhere.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .segments import AudioSegment

__all__ = ["AudioOutput", "AudioPlaybackManager", "CollectorSink"]


class CollectorSink:
    """Test/headless sink: collects (segment, pcm) plays."""

    def __init__(self):
        self.played: list = []

    def __call__(self, segment: AudioSegment, pcm: np.ndarray) -> None:
        self.played.append((segment, pcm))


class AudioOutput:
    """One playback channel (MonoAudioOutput.java role, sink-backed)."""

    def __init__(self, name: str, sink: Callable | None = None):
        self.name = name
        self.sink = sink or CollectorSink()
        self.current: AudioSegment | None = None
        self._consumed = 0

    @property
    def empty(self) -> bool:
        return self.current is None

    @property
    def priority(self) -> int:
        return (self.current.monitor_priority if self.current is not None
                else 1 << 30)

    def is_linked_to(self, segment: AudioSegment) -> bool:
        return (segment.linked_to is not None
                and segment.linked_to is self.current)

    def play(self, segment: AudioSegment) -> None:
        self.current = segment
        self._consumed = 0
        self.pump()

    def pump(self) -> None:
        """Push any newly available audio to the sink; release the
        output when the segment completes and is drained."""
        if self.current is None:
            return
        pcm = self.current.samples
        if len(pcm) > self._consumed:
            self.sink(self.current, pcm[self._consumed:])
            self._consumed = len(pcm)
        if self.current.complete and self._consumed >= len(pcm):
            self.current = None


class AudioPlaybackManager:
    def __init__(self, n_outputs: int = 2, sink_factory=None,
                 suppress_duplicates: bool = True):
        factory = sink_factory or (lambda name: CollectorSink())
        self.outputs = [AudioOutput(f"out{i}", factory(f"out{i}"))
                        for i in range(n_outputs)]
        self.suppress_duplicates = suppress_duplicates
        self._new: list[AudioSegment] = []
        self._pending: list[AudioSegment] = []
        self._ready: list[AudioSegment] = []
        self.dropped = 0

    def receive(self, segment: AudioSegment) -> None:
        self._new.append(segment)

    def _suppressed(self, s: AudioSegment) -> bool:
        return s.duplicate and self.suppress_duplicates

    def process(self) -> None:
        """One scheduler tick (processAudioSegments)."""
        # intake
        for s in self._new:
            if self._suppressed(s):
                self.dropped += 1
            elif len(s.samples):
                self._ready.append(s)
            else:
                self._pending.append(s)
        self._new.clear()
        # pending -> ready when audio arrives; drop empty-completed
        still = []
        for s in self._pending:
            if self._suppressed(s):
                self.dropped += 1
            elif len(s.samples):
                self._ready.append(s)
            elif s.complete:
                self.dropped += 1
            else:
                still.append(s)
        self._pending = still
        # drop do-not-monitor; route linked segments to their output
        still = []
        for s in self._ready:
            if s.do_not_monitor or self._suppressed(s):
                self.dropped += 1
                continue
            for out in self.outputs:
                if out.is_linked_to(s):
                    out.play(s)
                    break
            else:
                still.append(s)
        self._ready = still
        # priority sort; fill empty outputs, then preempt
        self._ready.sort(key=lambda s: s.monitor_priority)
        for out in self.outputs:
            if not self._ready:
                break
            if out.empty:
                out.play(self._ready.pop(0))
        for out in self.outputs:
            if not self._ready:
                break
            if self._ready[0].monitor_priority < out.priority:
                out.play(self._ready.pop(0))
        # drop completed segments that never got an output
        survivors = []
        for s in self._ready:
            if s.complete:
                self.dropped += 1
            else:
                survivors.append(s)
        self._ready = survivors
        # stream ongoing audio
        for out in self.outputs:
            out.pump()
