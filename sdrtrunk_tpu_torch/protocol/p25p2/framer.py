"""P25 Phase 2 batch framer (role of P25P2SuperFrameDetector.java:51 /
P25P2MessageFramer.java:57).

Fragment = 1440 bits: [ISCH0 40][TS_A 320][ISCH1 40][TS_B 320]
[SYNC 40][TS_C 320][SYNC 40][TS_D 320] (SuperFrameFragment.java:16-24).
The 40-bit sync (P25P2SyncPattern.java) sits at bit offsets 720 and 1080;
the framer correlates it at every dibit alignment, frames fragments
around hits, decodes both ISCH words for fragment/timeslot numbering,
and descrambles + parses the four timeslots.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import bits_to_dibits, dibits_to_bits, xor_popcount_correlate
from .isch import ISCH, isch_decode, isch_encode
from .scrambler import ScramblingSequence
from .timeslot import timeslot_decode

__all__ = ["P25P2Fragment", "P25P2Framer", "P25P2FragmentAssembler",
           "SYNC_BITS", "FRAGMENT_BITS"]

# P25P2SyncPattern.java: dibits +3+3+3-3 +3+3-3+3 +3+3+3-3 -3-3+3-3 -3-3-3-3
_SYNC_DIBITS = np.array([1, 1, 1, 3, 1, 1, 3, 1, 1, 1, 1, 3, 3, 3, 1, 3,
                         3, 3, 3, 3], dtype=np.uint8)
SYNC_BITS = dibits_to_bits(_SYNC_DIBITS)
FRAGMENT_BITS = 1440
_SYNC1_OFFSET = 720
_SYNC2_OFFSET = 1080
MAX_SYNC_BIT_ERRORS = 4

_TS_OFFSETS = [(0, 40), (360, 400), (720, 760), (1080, 1120)]


@dataclass(slots=True)
class P25P2Fragment:
    start: int                       # absolute dibit index of fragment start
    isch0: ISCH | None
    isch1: ISCH | None
    timeslots: list                  # up to 4 Timeslot (A..D)
    sync_errors: int = 0

    @property
    def fragment_number(self) -> int | None:
        for isch in (self.isch0, self.isch1):
            if isch is not None:
                return isch.isch_sequence
        return None


class P25P2Framer:
    """Streaming batch framer; needs scramble parameters (WACN/SYS/NAC)
    for the scrambled timeslots (learned from network status MACs)."""

    def __init__(self, wacn: int = 0, system: int = 0, nac: int = 0,
                 max_sync_errors: int = MAX_SYNC_BIT_ERRORS):
        self.scrambling = ScramblingSequence(wacn, system, nac)
        self.max_sync_errors = max_sync_errors
        self._carry = np.zeros(0, dtype=np.uint8)
        self._offset = 0

    def set_scramble_parameters(self, wacn: int, system: int,
                                nac: int) -> None:
        self.scrambling.update(wacn, system, nac)

    def process(self, dibits: np.ndarray) -> list[P25P2Fragment]:
        stream = np.concatenate([self._carry,
                                 np.asarray(dibits, np.uint8)])
        base = self._offset
        bits = dibits_to_bits(stream)
        frags: list[P25P2Fragment] = []
        errs = xor_popcount_correlate(bits, SYNC_BITS)
        consumed = -1
        for lag in np.nonzero(errs <= self.max_sync_errors)[0]:
            if lag % 2:
                continue
            start = int(lag) - _SYNC1_OFFSET
            if start < 0 or start <= consumed:
                continue
            if start + FRAGMENT_BITS > len(bits):
                break
            # confirm the second sync at +360 bits
            second = errs[start + _SYNC2_OFFSET] \
                if start + _SYNC2_OFFSET < len(errs) else 99
            if second > self.max_sync_errors:
                continue
            frag = self._frame(bits, start, int(errs[lag]) + int(second),
                               base)
            frags.append(frag)
            consumed = start
        keep_dibits = max((consumed + FRAGMENT_BITS) // 2 if consumed >= 0
                          else 0, len(stream) - FRAGMENT_BITS)
        self._carry = stream[keep_dibits:]
        self._offset = base + keep_dibits
        return frags

    def _frame(self, bits, start, sync_errors, base) -> P25P2Fragment:
        f = bits[start: start + FRAGMENT_BITS]
        isch0 = isch_decode(f[0:40])
        isch1 = isch_decode(f[360:400])
        ts_base = 0
        for isch in (isch0, isch1):
            if isch is not None:
                ts_base = isch.timeslot_offset
                break
        from .mac import parse_mac_pdu
        timeslots = []
        for unit, (isch_off, ts_off) in enumerate(_TS_OFFSETS):
            index = ts_base + unit
            channel = unit % 2
            seg = self.scrambling.segment(index)
            ts = timeslot_decode(f[ts_off: ts_off + 320], index, channel,
                                 seg)
            if ts is not None:
                if ts.mac_octets is not None:
                    ts.mac = parse_mac_pdu(ts.mac_octets)
                timeslots.append(ts)
        return P25P2Fragment(start=base + start // 2, isch0=isch0,
                             isch1=isch1, timeslots=timeslots,
                             sync_errors=sync_errors)


class P25P2FragmentAssembler:
    """Transmit-side fragment builder (for closed-loop tests)."""

    def __init__(self, wacn: int = 0xA4BC3, system: int = 0x123,
                 nac: int = 0x29A):
        self.scrambling = ScramblingSequence(wacn, system, nac)

    def assemble(self, fragment_number: int, timeslots: list,
                 superframe_sequence: int = 0) -> np.ndarray:
        """timeslots: 4 x (320-bit pre-scrambling timeslot arrays).
        Scrambled DUIDs get XORed with the scrambling segment."""
        from .timeslot import DUID_POSITIONS, duid_decode
        bits = np.zeros(FRAGMENT_BITS, dtype=np.uint8)
        bits[0:40] = isch_encode(0, fragment_number, True,
                                 superframe_sequence)
        bits[360:400] = isch_encode(1, fragment_number, True,
                                    superframe_sequence)
        bits[720:760] = SYNC_BITS
        bits[1080:1120] = SYNC_BITS
        for unit, (isch_off, ts_off) in enumerate(_TS_OFFSETS):
            ts = np.asarray(timeslots[unit], np.uint8).copy()
            duid, _ = duid_decode(ts)
            if duid is not None and duid.is_scrambled:
                index = 4 * fragment_number + unit \
                    if fragment_number in (0, 1, 2) else unit
                index = {0: 0, 1: 4, 2: 8}[fragment_number] + unit
                seg = self.scrambling.segment(index)
                duid_bits = ts[DUID_POSITIONS].copy()
                ts = ts ^ seg
                ts[DUID_POSITIONS] = duid_bits
            bits[ts_off: ts_off + 320] = ts
        return bits

    @staticmethod
    def to_dibits(fragments: list) -> np.ndarray:
        return bits_to_dibits(np.concatenate(fragments))
