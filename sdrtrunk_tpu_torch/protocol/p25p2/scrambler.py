"""P25 Phase 2 scrambling sequence (timeslot/LinearFeedbackShiftRegister
.java + ScramblingSequence.java).

44-bit Fibonacci LFSR, output = bit 43, feedback = taps 43^33^19^14^8^3,
seeded with WACN(20) | SYSTEM(12) | NAC(12); a 4320-bit superframe
sequence is generated, and each timeslot's 320-bit segment starts at bit
20 + 360 * timeslot_index (the sequence origin is mid-ISCH).
"""
from __future__ import annotations

import numpy as np

__all__ = ["lfsr_sequence", "ScramblingSequence"]

_TAPS = (43, 33, 19, 14, 8, 3)
_MASK = (1 << 44) - 1


def lfsr_sequence(wacn: int, system: int, nac: int,
                  length: int = 4320) -> np.ndarray:
    reg = ((wacn & 0xFFFFF) << 24) | ((system & 0xFFF) << 12) | (nac & 0xFFF)
    if reg == 0:
        reg = _MASK
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        bit = (reg >> 43) & 1
        out[i] = bit
        fb = bit
        for t in _TAPS[1:]:
            fb ^= (reg >> t) & 1
        reg = ((reg << 1) & _MASK) | fb
    return out


class ScramblingSequence:
    """Per-timeslot 320-bit scrambling segments for one WACN/SYS/NAC."""

    def __init__(self, wacn: int = 0, system: int = 0, nac: int = 0):
        self._key = None
        self.segments = np.zeros((12, 320), dtype=np.uint8)
        self.update(wacn, system, nac)

    def update(self, wacn: int, system: int, nac: int) -> None:
        key = (wacn, system, nac)
        if key == self._key:
            return
        self._key = key
        seq = lfsr_sequence(wacn, system, nac)
        for ts in range(12):
            start = 20 + 360 * ts
            self.segments[ts] = seq[start: start + 320]

    def segment(self, timeslot_index: int) -> np.ndarray:
        return self.segments[timeslot_index % 12]
