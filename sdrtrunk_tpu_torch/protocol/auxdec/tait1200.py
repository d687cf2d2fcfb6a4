"""Tait 1200-baud CCDI (GPS reports + SELCAL/ANI).

440-bit framed messages (module/decode/tait/Tait1200Decoder.java:34) on
two sync patterns (bits/SyncPattern.java:153,161).  ANI carries 8 ASCII
FROM / TO characters (Tait1200ANIMessage.java); GPS carries a packed
BCD-digit position/time report (Tait1200GPSMessage.java).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import to_bits, to_int
from ..framer import MessageFramer

__all__ = ["TAIT_GPS_SYNC", "TAIT_SELCAL_SYNC", "Tait1200ANIMessage",
           "Tait1200GPSMessage", "Tait1200Framer"]

TAIT_GPS_SYNC = to_bits("10100001010011011100")
TAIT_SELCAL_SYNC = to_bits("01000001100011101110")
MESSAGE_LENGTH = 440


def _ascii(bits: np.ndarray, start: int, count: int) -> str:
    """count ASCII characters of 8 bits each beginning at `start`."""
    chars = []
    for i in range(count):
        v = to_int(bits, start + 8 * i, start + 8 * (i + 1))
        chars.append(chr(v) if 32 <= v < 127 else "?")
    return "".join(chars).strip("?").strip()


@dataclass
class Tait1200ANIMessage:
    bits: np.ndarray

    @property
    def from_id(self) -> str:
        return _ascii(self.bits, 36, 8)

    @property
    def to_id(self) -> str:
        return _ascii(self.bits, 204, 8)

    @property
    def size(self) -> int:
        return to_int(self.bits, 20, 36)

    def __str__(self):
        return f"TAIT1200 ANI FROM:{self.from_id} TO:{self.to_id}"


def _digit(bits: np.ndarray, positions) -> int:
    v = 0
    for p in positions:
        v = (v << 1) | int(bits[p])
    return v


@dataclass
class Tait1200GPSMessage:
    bits: np.ndarray

    @property
    def from_id(self) -> str:
        return _ascii(self.bits, 36, 8)

    @property
    def latitude(self) -> float:
        b = self.bits
        sign = -1.0 if _digit(b, [317, 318]) else 1.0
        degrees = _digit(b, range(320, 324)) * 10 + _digit(b, range(324, 328))
        minutes = _digit(b, range(329, 332)) * 10 + _digit(b, range(332, 336))
        seconds = (_digit(b, range(336, 340)) * 10
                   + _digit(b, [340, 341, 342, 344])
                   + _digit(b, range(344, 348)) / 10.0)
        return sign * (degrees + minutes / 60.0 + seconds / 3600.0)

    @property
    def longitude(self) -> float:
        b = self.bits
        sign = -1.0 if _digit(b, [349, 350]) else 1.0
        degrees = (_digit(b, [351]) * 100
                   + _digit(b, range(352, 356)) * 10
                   + _digit(b, range(356, 360)))
        minutes = _digit(b, range(361, 364)) * 10 + _digit(b, range(364, 368))
        seconds = (_digit(b, range(368, 372)) * 10
                   + _digit(b, range(372, 376))
                   + _digit(b, range(376, 380)) / 10.0)
        return sign * (degrees + minutes / 60.0 + seconds / 3600.0)

    @property
    def speed(self) -> float:
        b = self.bits
        return (_digit(b, range(388, 392)) * 100
                + _digit(b, range(392, 396)) * 10
                + _digit(b, range(396, 400))
                + _digit(b, range(400, 404)) / 10.0)

    def __str__(self):
        return (f"TAIT1200 GPS FROM:{self.from_id} "
                f"LAT:{self.latitude:.5f} LON:{self.longitude:.5f}")


class Tait1200Framer:
    def __init__(self):
        self._gps = MessageFramer(TAIT_GPS_SYNC, MESSAGE_LENGTH)
        self._ani = MessageFramer(TAIT_SELCAL_SYNC, MESSAGE_LENGTH)

    def reset(self):
        self._gps.reset()
        self._ani.reset()

    def process(self, bits: np.ndarray):
        bits = np.asarray(bits)
        out: list = [Tait1200GPSMessage(m) for m in self._gps.process(bits)]
        out += [Tait1200ANIMessage(m) for m in self._ani.process(bits)]
        return out
