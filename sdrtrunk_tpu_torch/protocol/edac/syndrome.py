"""Syndrome-table linear block codes (CRC-protected words with single-bit
correction).

The reference ships hand-written syndrome lookup tables for several
protocols (edac/CRCFleetsync.java:37, edac/CRCLJ.java:52).  Those tables
are just ``x^p mod g(x)`` for each protected bit position, so here they
are derived from the generator polynomial instead of transcribed:

* Fleetsync: g(x) = x^15+x^14+x^13+x^11+x^4+x^2+1  (0xE815); verified
  against the reference table by the doubling identity
  s[i] = (s[i+1] << 1) mod g (e.g. table bit 46 = 0x383F = 2*0x6815 mod g).
* LoJack LJ1200: g(x) = x^16+x^14+x^13+x^11+x^10+x^9+x^8+x^6+x^5+x+1
  (0x16F63, "CRC-16 0x6F63" per edac/CRCLJ.java:40), same verification
  (table Address 26 = 0xDEC6 = 2*0x6F63).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["xpow_mod", "SyndromeCode", "CheckResult"]


def xpow_mod(power: int, poly: int, width: int) -> int:
    """Remainder of x^power modulo the generator polynomial.

    `poly` includes the leading x^width term (e.g. 0xE815 for width 15).
    """
    top = 1 << width
    r = 1
    for _ in range(power):
        r <<= 1
        if r & top:
            r ^= poly
    return r


@dataclass
class CheckResult:
    passed: bool
    corrected: bool
    bits: np.ndarray          # possibly-corrected copy of the input word
    error_position: int | None = None


class SyndromeCode:
    """Block code where each protected data bit has syndrome x^p mod g.

    `bit_powers[i]` is the polynomial power of protected bit i (in word
    order); the CRC field follows as `width` bits, MSB-first, with
    syndromes x^(width-1) .. x^0.  `init` is XORed into the computed
    checksum (the reference's "starting value", CRCFleetsync.java:115).
    """

    def __init__(self, poly: int, width: int, bit_powers, init: int = 0):
        self.poly = int(poly)
        self.width = int(width)
        self.init = int(init)
        self.bit_powers = list(bit_powers)
        self.syndromes = np.array(
            [xpow_mod(p, self.poly, self.width) for p in self.bit_powers],
            dtype=np.int64)
        # single-bit errors in the CRC field itself
        self.crc_syndromes = np.array(
            [1 << (self.width - 1 - i) for i in range(self.width)],
            dtype=np.int64)

    @property
    def data_length(self) -> int:
        return len(self.bit_powers)

    def checksum(self, data_bits: np.ndarray) -> int:
        data = np.asarray(data_bits, np.uint8)
        if len(data) != self.data_length:
            raise ValueError(
                f"expected {self.data_length} data bits, got {len(data)}")
        acc = self.init
        for s in self.syndromes[data != 0]:
            acc ^= int(s)
        return acc

    def encode(self, data_bits: np.ndarray) -> np.ndarray:
        """data bits -> data + CRC field (MSB-first)."""
        c = self.checksum(data_bits)
        crc = np.array([(c >> (self.width - 1 - i)) & 1
                        for i in range(self.width)], np.uint8)
        return np.concatenate([np.asarray(data_bits, np.uint8), crc])

    def check(self, word_bits: np.ndarray) -> CheckResult:
        """Check (and single-bit correct) a data+CRC word."""
        word = np.asarray(word_bits, np.uint8).copy()
        n = self.data_length
        data, crc = word[:n], word[n:n + self.width]
        received = 0
        for b in crc:
            received = (received << 1) | int(b)
        syndrome = self.checksum(data) ^ received
        if syndrome == 0:
            return CheckResult(True, False, word)
        hit = np.nonzero(self.syndromes == syndrome)[0]
        if len(hit):
            pos = int(hit[0])
            word[pos] ^= 1
            return CheckResult(True, True, word, pos)
        hit = np.nonzero(self.crc_syndromes == syndrome)[0]
        if len(hit):
            pos = n + int(hit[0])
            word[pos] ^= 1
            return CheckResult(True, True, word, pos)
        return CheckResult(False, False, word)
