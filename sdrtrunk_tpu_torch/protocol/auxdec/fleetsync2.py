"""Kenwood Fleetsync II (1200-baud AFSK).

Message layout per module/decode/fleetsync2/message/Fleetsync2Message.java:
5 bit reversals + 16-bit sync (0x23EB) + up to 8 x 64-bit blocks.  Each
block is 48 data bits + 15-bit CRC (g = 0xE815, init 1,
edac/CRCFleetsync.java) + 1 even-parity bit.  Fleet/ident values carry
the protocol's +99 / +999 display offsets.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..bits import to_bits, to_int
from ..edac.syndrome import SyndromeCode
from ..framer import MessageFramer

__all__ = ["FLEETSYNC2_SYNC", "FleetsyncMessageType", "Fleetsync2Message",
           "Fleetsync2Framer", "fleetsync_code", "check_block",
           "encode_block"]

# 5 rev bits + 16-bit sync 0x23EB (bits/SyncPattern.java:33)
FLEETSYNC2_SYNC = to_bits("010100010001111101011")
MESSAGE_LENGTH = 537          # Fleetsync2Decoder.java:34
HEADER = 21                   # revs + sync prefix inside the message
BLOCK = 64

# CRC-15: syndrome of message bit i (0..47 within a block) is x^(62-i) mod g
fleetsync_code = SyndromeCode(
    poly=0xE815, width=15, bit_powers=[62 - i for i in range(48)], init=1)


class FleetsyncMessageType(enum.Enum):
    ACKNOWLEDGE = "ACK"
    ANI = "ANI"
    EMERGENCY = "EMERG"
    GPS = "GPS"
    LONE_WORKER_EMERGENCY = "LONE WORKER"
    PAGING = "PAGE"
    STATUS = "STATUS"
    UNKNOWN = "UNK"


# flag bit positions within the framed message (inverted: 0 = flag true)
_FLAG_EMERGENCY = 22
_FLAG_LONE_WORKER = 24
_FLAG_PAGING = 26
_FLAG_END_OF_TRANSMISSION = 27
_FLAG_ANI = 29
_FLAG_STATUS = 30
_FLAG_ACKNOWLEDGE = 31
_FLAG_GPS = 35
_FLAG_FLEET_EXTENSION = 36


def check_block(bits64: np.ndarray) -> tuple[bool, np.ndarray, int]:
    """(valid, corrected 64-bit block, corrected-bit count). Even parity
    over all 64 bits, then CRC-15 check/correct over data+crc."""
    word = np.asarray(bits64, np.uint8).copy()
    res = fleetsync_code.check(word[:63])
    if int(word.sum()) % 2 != 0:
        # odd parity: a single-bit error somewhere in the 64 bits
        if res.passed and not res.corrected:
            word[63] ^= 1                      # the parity bit itself
            return True, word, 1
        if res.passed and res.corrected:
            word[:63] = res.bits               # single data/CRC bit
            if int(word.sum()) % 2 == 0:
                return True, word, 1
        return False, word, 0
    # even parity: CRC must agree outright (>=2 errors otherwise;
    # the reference likewise does not correct in this case)
    if res.passed and not res.corrected:
        return True, word, 0
    return False, word, 0


def encode_block(data48: np.ndarray) -> np.ndarray:
    """48 data bits -> 64-bit block (CRC-15 + even parity)."""
    word63 = fleetsync_code.encode(data48)
    parity = int(word63.sum()) % 2
    return np.concatenate([word63, np.array([parity], np.uint8)])


@dataclass
class Fleetsync2Message:
    bits: np.ndarray
    message_type: FleetsyncMessageType
    fleet_from: int
    ident_from: int
    fleet_to: int
    ident_to: int
    valid: bool
    corrected_bits: int = 0
    fields: dict = field(default_factory=dict)

    @property
    def from_id(self) -> int:
        return ((self.fleet_from + 99) << 12) + self.ident_from + 999

    @property
    def to_id(self) -> int:
        return ((self.fleet_to + 99) << 12) + self.ident_to + 999

    def __str__(self):
        return (f"FSYNC2 {self.message_type.value} FROM:{self.from_id} "
                f"TO:{self.to_id}")


def _flag(bits, pos) -> bool:
    """Inverted-sense flag: 0 means set (Fleetsync2Message.java:251)."""
    return bits[pos] == 0


def get_message_type(bits: np.ndarray) -> FleetsyncMessageType:
    if _flag(bits, _FLAG_ACKNOWLEDGE):
        return FleetsyncMessageType.ACKNOWLEDGE
    if _flag(bits, _FLAG_GPS):
        return FleetsyncMessageType.GPS
    if _flag(bits, _FLAG_STATUS):
        return FleetsyncMessageType.STATUS
    if _flag(bits, _FLAG_ANI):
        return FleetsyncMessageType.ANI
    if _flag(bits, _FLAG_PAGING):
        return FleetsyncMessageType.PAGING
    if _flag(bits, _FLAG_LONE_WORKER) and _flag(bits, _FLAG_EMERGENCY):
        return FleetsyncMessageType.LONE_WORKER_EMERGENCY
    return FleetsyncMessageType.UNKNOWN


def parse(message: np.ndarray) -> Fleetsync2Message:
    bits = np.asarray(message, np.uint8)
    valid, block1, corrected = check_block(bits[HEADER:HEADER + BLOCK])
    bits = bits.copy()
    bits[HEADER:HEADER + BLOCK] = block1
    mtype = get_message_type(bits)
    fleet = to_int(bits, 37, 45)
    from_ident = to_int(bits, 45, 57)
    to_ident = to_int(bits, 57, 69)
    fleet_to = fleet
    if _flag(bits, _FLAG_FLEET_EXTENSION):
        v2, block2, c2 = check_block(bits[HEADER + BLOCK:HEADER + 2 * BLOCK])
        corrected += c2
        if v2:
            fleet_to = to_int(block2, 0, 8)
    msg = Fleetsync2Message(
        bits=bits, message_type=mtype, fleet_from=fleet,
        ident_from=from_ident, fleet_to=fleet_to, ident_to=to_ident,
        valid=valid, corrected_bits=corrected)
    if mtype is FleetsyncMessageType.STATUS:
        # status value field (block 1 status bits 21-27 + message type)
        msg.fields["status"] = to_int(bits, 21, 28)
    if mtype is FleetsyncMessageType.GPS and len(bits) >= 500:
        msg.fields.update(_parse_gps(bits))
    return msg


def _parse_gps(bits: np.ndarray) -> dict:
    """Location report fields (fleetsync2/message/LocationReport.java)."""
    def ddm_to_dd(degrees_minutes: int, fractional: int) -> float:
        degrees = degrees_minutes // 100
        minutes = (degrees_minutes % 100) + fractional / 10000.0
        return degrees + minutes / 60.0

    lat_dm = to_int(bits, 221, 237)
    lat_frac = to_int(bits, 238, 252)
    lon_dm = to_int(bits, 301, 317)
    lon_frac = to_int(bits, 318, 332)
    heading = to_int(bits, 353, 366) / 10.0
    speed = to_int(bits, 484, 492) + to_int(bits, 492, 500) / 255.0
    return {
        "latitude": ddm_to_dd(lat_dm, lat_frac),
        "longitude": ddm_to_dd(lon_dm, lon_frac),
        "heading": heading,
        "speed": speed,
    }


class Fleetsync2Framer:
    """Streaming bit consumer -> parsed Fleetsync II messages."""

    def __init__(self):
        self._framer = MessageFramer(FLEETSYNC2_SYNC, MESSAGE_LENGTH)

    def reset(self):
        self._framer.reset()

    def process(self, bits: np.ndarray) -> list[Fleetsync2Message]:
        return [parse(m) for m in self._framer.process(bits)]
