"""Duplicate call detection: suppress the same call heard on multiple
channels (role of audio/DuplicateCallDetector.java:52 — match by TO
talkgroup within a time window).
"""
from __future__ import annotations


from ..runtime.identifiers import IdentifierForm, IdentifierRole
from .segments import AudioSegment

__all__ = ["DuplicateCallDetector"]


class DuplicateCallDetector:
    def __init__(self, window_seconds: float = 2.0):
        self.window_seconds = window_seconds
        self._recent: dict = {}   # (protocol, talkgroup) -> start_time

    def is_duplicate(self, segment: AudioSegment) -> bool:
        """Marks and reports duplicates; first arrival wins."""
        to = segment.identifiers.get(IdentifierForm.TALKGROUP,
                                     IdentifierRole.TO)
        if to is None:
            to = segment.identifiers.get(IdentifierForm.TALKGROUP)
        if to is None:
            return False
        key = (to.protocol, to.value)
        last = self._recent.get(key)
        if last is not None and abs(segment.start_time - last) \
                <= self.window_seconds:
            segment.duplicate = True
            return True
        self._recent[key] = segment.start_time
        return False

    def prune(self, now: float) -> None:
        for key in [k for k, t in self._recent.items()
                    if now - t > 10.0 * self.window_seconds]:
            del self._recent[key]
