"""Passport trunking protocol (role of module/decode/passport).

Word format (68 bits, passport/PassportMessage.java:39-49): SYNC(9) DCC(2)
LCN(11) SITE(7) GROUP(16) TYPE(4) FREE(11) CHECKSUM(8). Same 300-baud
sub-audible FSK physical layer as LTR (PassportDecoder.java:46 reuses
LTRDecoder with message length 68); checksum is the 8-bit linear code with
the standard column table (edac/CRCPassport.java).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from .bits import from_int, to_bits, to_int, xor_popcount_correlate

__all__ = ["PassportMessage", "PassportMessageType", "PassportFramer",
           "passport_checksum", "passport_encode_word", "SYNC_PASSPORT"]

SYNC_PASSPORT = to_bits("101011000")
WORD_BITS = 68

# columns for bits 9..59 (edac/CRCPassport.java sCHECKSUMS)
_COLUMNS = np.array([
    0x6E, 0xBF,                                       # DCC
    0xD6, 0xE3, 0xF8, 0x7C, 0x3E, 0x97, 0xC2, 0xE9, 0x75, 0x3B, 0x94,  # LCN
    0x4A, 0xAD, 0x57, 0xA2, 0xD9, 0x6D, 0x37,         # SITE
    0x92, 0xC1, 0x61, 0x31, 0x19, 0x0D, 0x07, 0x8A,   # GROUP 15..8
    0xCD, 0x67, 0xBA, 0xD5, 0x6B, 0xBC, 0x5E, 0xA7,   # GROUP 7..0
    0xDA, 0xE5, 0x73, 0xB0,                           # TYPE
    0x58, 0x2C, 0x16, 0x83, 0xC8, 0x64, 0x32, 0x91, 0x49, 0x25, 0x13,  # FREE
], dtype=np.int64)


class PassportMessageType(enum.Enum):
    CALL_START = "CA_STRT"
    CALL_END = "CA_ENDD"
    CALL_PAGE = "CA_PAGE"
    DATA_START = "DA_STRT"
    IDLE = "SY_IDLE"
    ASSIGN_TALKGROUP = "ID_TGAS"
    RADIO_ID = "ID_RDIO"
    RADIO_REGISTER = "RA_REGI"
    UNKNOWN = "UN_KNWN"


@dataclass
class PassportMessage:
    dcc: int
    lcn: int
    site: int
    group: int
    type_number: int
    free: int
    message_type: PassportMessageType
    start: int = 0

    @staticmethod
    def classify(type_number: int, lcn: int, free: int
                 ) -> PassportMessageType:
        """PassportMessage.getMessageType (PassportMessage.java:125-174)."""
        T = PassportMessageType
        if type_number in (0, 2):
            return T.CALL_START
        if type_number == 1:
            if free == 2042:
                return T.ASSIGN_TALKGROUP
            if lcn < 1792:
                return T.CALL_START
            if lcn in (1792, 1793):
                return T.IDLE
            if lcn == 2047:
                return T.CALL_END
            return T.UNKNOWN
        if type_number == 5:
            return T.CALL_PAGE
        if type_number == 6:
            return T.RADIO_ID
        if type_number == 9:
            return T.DATA_START
        if type_number == 11:
            return T.RADIO_REGISTER
        return T.UNKNOWN


def passport_checksum(payload51: np.ndarray) -> int:
    b = np.asarray(payload51, np.uint8)
    s = 0
    for pos in np.nonzero(b)[0]:
        s ^= int(_COLUMNS[pos])
    return s


def passport_encode_word(dcc: int, lcn: int, site: int, group: int,
                         type_number: int, free: int) -> np.ndarray:
    payload = np.concatenate([
        from_int(dcc, 2), from_int(lcn, 11), from_int(site, 7),
        from_int(group, 16), from_int(type_number, 4), from_int(free, 11)])
    word = np.concatenate([SYNC_PASSPORT, payload,
                           from_int(passport_checksum(payload), 8)])
    return word.astype(np.uint8)


def _decode_word(bits68: np.ndarray, start: int) -> PassportMessage | None:
    b = np.asarray(bits68, np.uint8)
    payload = b[9:60]
    if passport_checksum(payload) != to_int(b, 60, 68):
        return None
    lcn = to_int(b, 11, 22)
    tnum = to_int(b, 45, 49)
    free = to_int(b, 49, 60)
    return PassportMessage(
        dcc=to_int(b, 9, 11), lcn=lcn, site=to_int(b, 22, 29),
        group=to_int(b, 29, 45), type_number=tnum, free=free,
        message_type=PassportMessage.classify(tnum, lcn, free), start=start)


class PassportFramer:
    """Batch framer over slicer bit streams."""

    def __init__(self):
        self._carry = np.zeros(0, np.uint8)
        self._offset = 0

    def process(self, bits: np.ndarray) -> list[PassportMessage]:
        stream = np.concatenate([self._carry, np.asarray(bits, np.uint8)])
        base = self._offset
        msgs: list[PassportMessage] = []
        errs = xor_popcount_correlate(stream, SYNC_PASSPORT)
        consumed = 0
        for lag in np.nonzero(errs == 0)[0]:
            if lag < consumed:
                continue
            if lag + WORD_BITS > len(stream):
                break
            msg = _decode_word(stream[lag: lag + WORD_BITS], base + int(lag))
            if msg is not None:
                msgs.append(msg)
                consumed = int(lag) + WORD_BITS
        keep_from = max(consumed, len(stream) - WORD_BITS + 1)
        self._carry = stream[keep_from:]
        self._offset = base + keep_from
        return msgs
