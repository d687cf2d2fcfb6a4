"""Golay codes: (23,12,7) perfect, (24,12,8) extended, (18,6,8) shortened.

P25/DMR convention (matches edac/Golay24.java:32 checksum table): cyclic
generator g(x) = x^11+x^10+x^6+x^5+x^4+x^2+1 (0xC75), systematic with data
MSB-first followed by 11 parity bits (plus an overall even-parity bit for
the extended code). Decoding uses the perfect-code property: a precomputed
syndrome table maps all 2047 nonzero syndromes to their unique <=3-bit error
pattern.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import combinations

import numpy as np

__all__ = ["golay23_encode", "golay23_decode", "golay24_encode",
           "golay24_decode", "golay24_decode_batch", "golay18_encode",
           "golay18_decode"]

_GEN = 0xC75  # ascending-power bit i = coeff of x^i


def _parity12(data_bits: np.ndarray) -> int:
    """11 parity bits (as int, MSB-first) for 12 data bits."""
    rem = 0  # bit i = coeff of x^i, 11 bits
    for bit in data_bits:
        fb = ((rem >> 10) & 1) ^ int(bit)
        rem = (rem << 1) & 0x7FF
        if fb:
            rem ^= _GEN & 0x7FF
    return rem


@lru_cache(maxsize=1)
def _rows() -> np.ndarray:
    rows = np.zeros(12, dtype=np.int64)
    for i in range(12):
        d = np.zeros(12, dtype=np.uint8)
        d[i] = 1
        rows[i] = _parity12(d)
    return rows


@lru_cache(maxsize=1)
def _syndrome_table() -> dict:
    """syndrome -> tuple of error positions (0..22), all weight <= 3."""
    rows = _rows()
    # column syndrome contribution of each of the 23 bit positions
    cols = np.zeros(23, dtype=np.int64)
    cols[:12] = rows
    for j in range(11):
        cols[12 + j] = 1 << (10 - j)
    table = {}
    for w in (1, 2, 3):
        for pos in combinations(range(23), w):
            s = 0
            for p in pos:
                s ^= int(cols[p])
            table[s] = pos
    assert len(table) == 2047
    return table


def _syndrome(word23: np.ndarray) -> int:
    cols = np.concatenate(
        [_rows(), (1 << (10 - np.arange(11))).astype(np.int64)])
    s = 0
    for p in np.nonzero(word23)[0]:
        s ^= int(cols[p])
    return s


def golay23_encode(data: np.ndarray) -> np.ndarray:
    d = np.asarray(data, np.uint8)
    if len(d) != 12:
        raise ValueError("Golay23 expects 12 data bits")
    parity = _parity12(d)
    pbits = np.array([(parity >> (10 - i)) & 1 for i in range(11)], np.uint8)
    return np.concatenate([d, pbits])


def golay23_decode(word: np.ndarray):
    """(23,) -> (corrected 23 bits, n_errors). Perfect code: always <= 3."""
    w = np.asarray(word, np.uint8).copy()
    if len(w) != 23:
        raise ValueError("Golay23 expects 23 bits")
    s = _syndrome(w)
    if s == 0:
        return w, 0
    pos = _syndrome_table()[s]
    w[list(pos)] ^= 1
    return w, len(pos)


def golay24_encode(data: np.ndarray) -> np.ndarray:
    cw = golay23_encode(data)
    parity = np.array([int(cw.sum()) & 1], np.uint8)
    return np.concatenate([cw, parity])


def golay24_decode(word: np.ndarray):
    """(24,) -> (corrected, n_errors | None). Corrects <=3, detects 4."""
    w = np.asarray(word, np.uint8).copy()
    if len(w) != 24:
        raise ValueError("Golay24 expects 24 bits")
    corrected23, nerr = golay23_decode(w[:23])
    out = np.concatenate([corrected23, w[23:]])
    if int(out.sum()) & 1:  # overall parity mismatch -> parity bit error
        out[23] ^= 1
        nerr += 1
    if nerr >= 4:
        return w, None  # d=8: weight-4 patterns are detect-only
    return out, nerr


@lru_cache(maxsize=1)
def _batch_tables() -> tuple:
    """(colbits (23,11) uint8, pos_lut (2048,3) int16 padded -1,
    weight_lut (2048,) int16) for vectorized syndrome decode."""
    cols = np.concatenate(
        [_rows(), (1 << (10 - np.arange(11))).astype(np.int64)])
    colbits = ((cols[:, None] >> (10 - np.arange(11))[None, :]) & 1
               ).astype(np.uint8)
    pos = np.full((2048, 3), -1, np.int16)
    wt = np.zeros(2048, np.int16)
    for s, positions in _syndrome_table().items():
        wt[s] = len(positions)
        pos[s, :len(positions)] = positions
    return colbits, pos, wt


def golay24_decode_batch(words: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized golay24_decode of (N, 24) words.

    Returns (corrected (N, 24), nerr (N,)) with nerr in 0..3 or -1 for
    detect-only (the scalar path's None); detect-only rows return the
    original word, matching golay24_decode exactly. One syndrome matmul
    + LUT for the whole batch — the per-burst scalar decode was the
    measured bottleneck of 1000-carrier DMR slot-type framing."""
    w = np.asarray(words, np.uint8)
    colbits, pos, wt = _batch_tables()
    synd_bits = (w[:, :23] @ colbits) & 1                  # (N, 11)
    synd = synd_bits @ (1 << (10 - np.arange(11))).astype(np.int64)
    out = w.copy()
    p = pos[synd]                                          # (N, 3)
    rows = np.repeat(np.arange(len(w)), 3)
    flat = p.reshape(-1).astype(np.int64)
    ok = flat >= 0
    out[rows[ok], flat[ok]] ^= 1
    nerr = wt[synd].astype(np.int64)
    parity_bad = (out.sum(axis=1) & 1).astype(bool)
    out[parity_bad, 23] ^= 1
    nerr = nerr + parity_bad
    bad = nerr >= 4                                        # d=8 detect-only
    out[bad] = w[bad]
    nerr[bad] = -1
    return out, nerr


def golay18_encode(data: np.ndarray) -> np.ndarray:
    """(18,6,8): 6 data bits, shortened from (24,12) by 6 leading zero data
    bits (edac/Golay18.java behavior)."""
    d = np.asarray(data, np.uint8)
    if len(d) != 6:
        raise ValueError("Golay18 expects 6 data bits")
    full = golay24_encode(np.concatenate([np.zeros(6, np.uint8), d]))
    return full[6:]


def golay18_decode(word: np.ndarray):
    w = np.asarray(word, np.uint8)
    if len(w) != 18:
        raise ValueError("Golay18 expects 18 bits")
    full, nerr = golay24_decode(np.concatenate([np.zeros(6, np.uint8), w]))
    return full[6:], nerr
