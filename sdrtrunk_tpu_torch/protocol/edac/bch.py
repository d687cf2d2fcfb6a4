"""BCH(63,16,11) — the P25 NID code (NAC + DUID protection).

Decoding mirrors the reference's trick (edac/BCH_63_16_11.java:26): run a
binary-input Reed-Solomon(63,41) errors-only decode over GF(64) — the BCH
generator's roots alpha^1..alpha^22 give the same syndromes, so up to 11 bit
errors are corrected. Encoding (which the reference lacks — it only
receives) uses the true degree-47 BCH generator polynomial computed as the
LCM of minimal polynomials of alpha^1..alpha^22.
"""
from __future__ import annotations

import numpy as np

from .galois import GF64_P25
from .rs import ReedSolomon

__all__ = ["BCH_63_16_11"]


def _bch_generator_poly() -> np.ndarray:
    """Binary generator polynomial (ascending coeffs) for BCH(63,16,11)."""
    gf = GF64_P25
    covered = set()
    g = np.array([1], dtype=np.int64)  # ascending binary coeffs
    for i in range(1, 23):
        if i in covered:
            continue
        # conjugacy class of alpha^i
        cls = []
        j = i
        while j not in cls:
            cls.append(j)
            j = (j * 2) % 63
        covered.update(cls)
        # minimal polynomial = prod (x - alpha^j) for j in class
        m = np.array([1], dtype=np.int64)
        for j in cls:
            m = gf.poly_mul(m, np.array([int(gf.pow_alpha(j)), 1], np.int64))
        assert np.all((m == 0) | (m == 1)), "minimal poly must be binary"
        # multiply into g over GF(2)
        out = np.zeros(len(g) + len(m) - 1, dtype=np.int64)
        for a, ga in enumerate(g):
            if ga:
                out[a: a + len(m)] ^= m
        g = out
    return g


class BCH_63_16_11:
    N, K = 63, 16

    def __init__(self):
        self._rs = ReedSolomon(63, 41, GF64_P25)
        self._gen = _bch_generator_poly()  # degree 47
        assert len(self._gen) == 48
        # binary parity-check rows: M[k] = x^(62-k) mod g(x) (ascending
        # coeffs, 47 wide). A word is a valid codeword iff
        # bits @ M % 2 == 0 — one uint8 matmul checks a whole batch,
        # ~50x cheaper than the GF(64) syndrome path (used by the bank
        # framer to screen every NID candidate of every channel).
        m = np.zeros((63, 47), np.uint8)
        cur = np.zeros(48, np.uint8)
        cur[0] = 1
        g = self._gen.astype(np.uint8)
        for power in range(63):
            m[62 - power] = cur[:47]
            cur = np.concatenate([[0], cur[:47]])
            if cur[47]:
                cur ^= g
        self._parity_rows = m

    def check_batch(self, bits: np.ndarray) -> np.ndarray:
        """(..., 63) bit words -> (...,) bool: True where the word is a
        valid BCH(63,16) codeword (zero remainder mod g)."""
        # f32 BLAS matmul: parity sums < 64 are exact in f32 and the
        # int64 matmul has no BLAS path (~50 ms/chunk at bank scale)
        b = np.asarray(bits, np.float32)
        rem = (b @ self._parity_rows.astype(np.float32)
               ).astype(np.int64) & 1
        return ~np.any(rem, axis=-1)

    def encode(self, data_bits: np.ndarray) -> np.ndarray:
        """16 data bits -> 64-bit NID word (63 BCH + even-parity bit)."""
        d = np.asarray(data_bits, np.int64)
        if len(d) != 16:
            raise ValueError("BCH(63,16) expects 16 data bits")
        # systematic: parity = x^47 * d(x) mod g(x)
        rem = np.zeros(47, dtype=np.int64)  # ascending
        for bit in d:  # MSB (highest power) first
            feedback = int(rem[-1]) ^ int(bit)
            rem[1:] = rem[:-1]
            rem[0] = 0
            if feedback:
                rem ^= self._gen[:-1]
        word = np.concatenate([d, rem[::-1]])
        parity = np.array([int(word.sum()) & 1], np.int64)
        return np.concatenate([word, parity]).astype(np.uint8)

    def decode(self, bits: np.ndarray):
        """63- or 64-bit word -> (corrected 16 data bits, n_errors | None)."""
        b = np.asarray(bits, np.int64)
        if len(b) == 64:
            b = b[:63]
        if len(b) != 63:
            raise ValueError("BCH(63,16) expects 63 or 64 bits")
        corrected, nerr = self._rs.decode(b)
        if nerr is None:
            return b[:16].astype(np.uint8), None
        return corrected[:16].astype(np.uint8), nerr
