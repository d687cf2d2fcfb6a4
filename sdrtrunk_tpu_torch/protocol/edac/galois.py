"""Galois field GF(2^m) arithmetic with NumPy table lookups.

Field definitions in use (matching the standards the reference codes target):
  * GF(64),  p(x) = x^6 + x + 1          — P25 RS/BCH (TIA-102.BAAA)
  * GF(16),  p(x) = x^4 + x + 1          — DMR RS(12,9,4) (ETSI TS 102 361-1)
  * GF(256), p(x) = x^8+x^4+x^3+x^2+1    — DMR full-frame RS(255,.)
"""
from __future__ import annotations

import numpy as np

__all__ = ["GF", "GF64_P25", "GF16_DMR", "GF256_DMR"]


class GF:
    """GF(2^m) with exp/log tables. `prim_poly` includes the x^m term,
    e.g. 0b1000011 for x^6 + x + 1."""

    def __init__(self, m: int, prim_poly: int):
        self.m = m
        self.size = 1 << m
        self.prim_poly = prim_poly
        exp = np.zeros(2 * self.size, dtype=np.int64)
        log = np.zeros(self.size, dtype=np.int64)
        x = 1
        for i in range(self.size - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.size:
                x ^= prim_poly
        # duplicate for mod-free exponent addition
        exp[self.size - 1: 2 * (self.size - 1)] = exp[: self.size - 1]
        self.exp = exp
        self.log = log
        log[0] = -1  # sentinel

    def mul(self, a, b):
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a, np.int64)
        if np.any(a == 0):
            raise ZeroDivisionError("GF inverse of 0")
        return self.exp[(self.size - 1) - self.log[a]]

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow_alpha(self, i):
        """alpha^i for any integer i (vectorized)."""
        i = np.asarray(i, np.int64) % (self.size - 1)
        return self.exp[i]

    def poly_eval(self, coeffs: np.ndarray, x):
        """Evaluate polynomial with coeffs[i] * X^i at points x (Horner)."""
        x = np.asarray(x, np.int64)
        out = np.zeros_like(x)
        for c in coeffs[::-1]:
            out = self.mul(out, x) ^ int(c)
        return out

    def poly_mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        out = np.zeros(len(a) + len(b) - 1, dtype=np.int64)
        for i, ai in enumerate(a):
            if ai:
                out[i: i + len(b)] ^= self.mul(int(ai), b)
        return out


GF64_P25 = GF(6, 0b1000011)           # x^6 + x + 1
GF16_DMR = GF(4, 0b10011)             # x^4 + x + 1
GF256_DMR = GF(8, 0b100011101)        # x^8 + x^4 + x^3 + x^2 + 1
