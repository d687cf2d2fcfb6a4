"""LoJack LJ-1200 (1200-baud AFSK).

80-bit block per edac/CRCLJ.java:28-40: 8 rev bits + 8-bit sync + VRC +
LRC + 4-bit function + 28-bit address + CRC-16 over function+address
(g = 0x16F63, init 0).  Tower messages sync on 0x550F, transponder
replies on 0x2AD5 (bits/SyncPattern.java:43,52).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import hex_to_bits, to_int, bits_to_hex
from ..edac.syndrome import SyndromeCode
from ..framer import MessageFramer

__all__ = ["LJ1200_SYNC", "LJ1200_TRANSPONDER_SYNC", "lj_code",
           "LJ1200Message", "LJ1200Framer", "encode_word"]

LJ1200_SYNC = hex_to_bits("550F")
LJ1200_TRANSPONDER_SYNC = hex_to_bits("2AD5")
MESSAGE_LENGTH = 80                          # LJ1200Decoder.java:35

REPLY_CODE = ["0", "1", "2", "3", "4", "5", "6", "7", "8", "9", "A", "C",
              "D", "E", "F", "G", "H", "J", "K", "L", "M", "N", "P", "Q",
              "R", "S", "T", "U", "V", "W", "X", "Y"]

# Protected region = message bits 32..63; CRCLJ.checkAndCorrect indexes
# its syndrome table by (bit - 32), so bit 32 = function LSB (x^47) down
# to bit 63 = address MSB (x^16 = 0x6F63, table "Address 27").  Verified
# by the doubling identity up the table (see edac/syndrome.py docstring).
_POWERS = [79 - b for b in range(32, 64)]

lj_code = SyndromeCode(poly=0x16F63, width=16, bit_powers=_POWERS, init=0)


def encode_word(function: int, address: int,
                transponder: bool = False) -> np.ndarray:
    """Build a full 80-bit LJ word (revs+sync+VRC+LRC+fn+addr+CRC)."""
    sync = LJ1200_TRANSPONDER_SYNC if transponder else LJ1200_SYNC
    body = np.concatenate([
        hex_to_bits("00", 16),                # VRC + LRC placeholder
        # function LSB at bit 32, address LSB at bit 36 (fields are read
        # back MSB-first via the reversed index arrays)
        np.array([(function >> i) & 1 for i in range(4)], np.uint8),
        np.array([(address >> i) & 1 for i in range(28)], np.uint8),
    ])
    protected = body[16:48]
    word = lj_code.encode(protected)          # 32 data + 16 crc
    return np.concatenate([sync, body[:16], word])


@dataclass
class LJ1200Message:
    bits: np.ndarray
    transponder: bool
    valid: bool
    corrected_bits: int = 0

    @property
    def function(self) -> int:
        # FUNCTION bits listed LSB-first {35,34,33,32}
        return to_int(self.bits[32:36][::-1])

    @property
    def address(self) -> int:
        # ADDRESS bits listed LSB-first {63..36}
        return to_int(self.bits[36:64][::-1])

    @property
    def vrc(self) -> str:
        return bits_to_hex(self.bits[16:24][::-1])

    @property
    def lrc(self) -> str:
        return bits_to_hex(self.bits[24:32][::-1])

    @property
    def reply_codes(self) -> str:
        """Five 5-bit reply code characters (LJ1200Message.java REPLY_*)."""
        groups = [[39, 38, 37, 36, 43], [42, 41, 40, 47, 46],
                  [45, 44, 51, 50, 49], [48, 55, 54, 53, 52],
                  [59, 58, 57, 56, 63]]
        out = []
        for g in groups:
            v = 0
            for i in g:
                v = (v << 1) | int(self.bits[i])
            out.append(REPLY_CODE[v])
        return "".join(out)

    def __str__(self):
        kind = "XPND" if self.transponder else "TOWER"
        return (f"LJ1200 {kind} FN:{self.function:X} "
                f"ADDR:{self.address:07X}")


def parse(message: np.ndarray, transponder: bool) -> LJ1200Message:
    bits = np.asarray(message, np.uint8)
    # check/correct function+address against the trailing CRC-16
    word = np.concatenate([bits[32:64], bits[64:80]])
    res = lj_code.check(word)
    fixed = bits.copy()
    fixed[32:64] = res.bits[:32]
    fixed[64:80] = res.bits[32:48]
    return LJ1200Message(bits=fixed, transponder=transponder,
                         valid=res.passed,
                         corrected_bits=1 if res.corrected else 0)


class LJ1200Framer:
    """Dual framer: tower + transponder sync patterns."""

    def __init__(self):
        self._tower = MessageFramer(LJ1200_SYNC, MESSAGE_LENGTH)
        self._xpnd = MessageFramer(LJ1200_TRANSPONDER_SYNC, MESSAGE_LENGTH)

    def reset(self):
        self._tower.reset()
        self._xpnd.reset()

    def process(self, bits: np.ndarray) -> list[LJ1200Message]:
        out = [parse(m, False) for m in self._tower.process(bits)]
        out += [parse(m, True) for m in self._xpnd.process(np.asarray(bits))]
        return out
