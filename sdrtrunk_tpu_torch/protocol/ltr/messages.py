"""LTR Standard word codec, framer, and message typing.

Message-type rules mirror LTRStandardMessageProcessor.java:50-94:
valid channel numbers are 1..20; IDLE when channel == free and
group == 255; CALL_END when channel == 31; otherwise CALL.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..bits import from_int, to_bits, to_int, xor_popcount_correlate

__all__ = ["LTRMessage", "LTRMessageType", "LTRFramer", "ltr_checksum",
           "ltr_encode_word", "SYNC_OSW", "SYNC_ISW"]

# bits/SyncPattern.java LTR_STANDARD_OSW / _ISW
SYNC_OSW = to_bits("101011000")
SYNC_ISW = to_bits("010100111")

WORD_BITS = 40

# per-bit checksum columns for the 24 payload bits AREA..FREE
# (edac/CRCLTR.java sCHECKSUMS — protocol-defined constants)
_CHECKSUM_COLUMNS = np.array([
    0x38,                               # area
    0x1C, 0x0E, 0x46, 0x23, 0x51,      # channel 4..0
    0x68, 0x75, 0x7A, 0x3D, 0x1F,      # home 4..0
    0x4F, 0x26, 0x52, 0x29, 0x15, 0x0B, 0x45, 0x62,  # group 7..0
    0x31, 0x19, 0x0D, 0x07, 0x43,      # free 4..0
], dtype=np.int64)


class LTRMessageType(enum.Enum):
    IDLE = "IDLE"
    CALL = "CALL"
    CALL_END = "CALL_END"
    UNKNOWN = "UNKNOWN"


@dataclass
class LTRMessage:
    area: int
    channel: int
    home: int
    group: int
    free: int
    message_type: LTRMessageType
    direction: str               # "OSW" | "ISW"
    start: int = 0

    @staticmethod
    def classify(channel: int, home: int, group: int,
                 free: int) -> LTRMessageType:
        def valid(c):
            return 1 <= c <= 20
        if valid(channel) and valid(home) and valid(free):
            if channel == free and group == 255:
                return LTRMessageType.IDLE
            return LTRMessageType.CALL
        if channel == 31 and valid(home) and valid(free):
            return LTRMessageType.CALL_END
        return LTRMessageType.UNKNOWN


def ltr_checksum(payload24: np.ndarray) -> int:
    """7-bit checksum of the 24 payload bits (AREA..FREE)."""
    b = np.asarray(payload24, np.uint8)
    s = 0
    for pos in np.nonzero(b)[0]:
        s ^= int(_CHECKSUM_COLUMNS[pos])
    return s


def ltr_encode_word(area: int, channel: int, home: int, group: int,
                    free: int, direction: str = "OSW") -> np.ndarray:
    """-> 40-bit LTR word (ISW is the bit-inverse of the OSW form)."""
    payload = np.concatenate([
        from_int(area, 1), from_int(channel, 5), from_int(home, 5),
        from_int(group, 8), from_int(free, 5)])
    word = np.concatenate([
        SYNC_OSW, payload, from_int(ltr_checksum(payload), 7)])
    if direction == "ISW":
        word = word ^ 1
    return word.astype(np.uint8)


def _decode_word(bits40: np.ndarray, direction: str,
                 start: int) -> LTRMessage | None:
    b = np.asarray(bits40, np.uint8)
    if direction == "ISW":
        # ISW is the bit-flipped OSW (LTRStandardMessageProcessor.java:56)
        b = b ^ 1
    payload = b[9:33]
    calc = ltr_checksum(payload)
    rx = to_int(b, 33, 40)
    if calc != rx and (calc ^ 0x7F) != rx:
        return None
    channel = to_int(b, 10, 15)
    home = to_int(b, 15, 20)
    group = to_int(b, 20, 28)
    free = to_int(b, 28, 33)
    return LTRMessage(
        area=int(b[9]), channel=channel, home=home, group=group, free=free,
        message_type=LTRMessage.classify(channel, home, group, free),
        direction=direction, start=start)


class LTRFramer:
    """Batch framer over slicer bit streams (either direction)."""

    def __init__(self, direction: str = "OSW"):
        self.direction = direction
        self._sync = SYNC_OSW if direction == "OSW" else SYNC_ISW
        self._carry = np.zeros(0, np.uint8)
        self._offset = 0

    def process(self, bits: np.ndarray) -> list[LTRMessage]:
        stream = np.concatenate([self._carry, np.asarray(bits, np.uint8)])
        base = self._offset
        msgs: list[LTRMessage] = []
        errs = xor_popcount_correlate(stream, self._sync)
        consumed = 0
        for lag in np.nonzero(errs == 0)[0]:
            if lag < consumed:
                continue
            if lag + WORD_BITS > len(stream):
                break
            msg = _decode_word(stream[lag: lag + WORD_BITS],
                               self.direction, base + int(lag))
            if msg is not None:
                msgs.append(msg)
                consumed = int(lag) + WORD_BITS
        keep_from = max(consumed, len(stream) - WORD_BITS + 1)
        self._carry = stream[keep_from:]
        self._offset = base + keep_from
        return msgs
