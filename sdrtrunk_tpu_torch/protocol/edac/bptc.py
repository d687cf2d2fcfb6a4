"""DMR BPTC(196,96) block product turbo code (ETSI TS 102 361-1 B.1.1).

Structure (matches edac/BPTC_196_96.java behavior): 196 bits = 1 pad bit +
a 13x15 matrix; rows are Hamming(15,11,3) codewords, columns are
Hamming(13,9,3) codewords; on-air bits are interleaved with
deinterleaved[x] = interleaved[(181 * x) % 196]. The 96 info bits occupy
rows 0-8, columns 0-10, minus 3 leading pad positions in row 0.
Decoding alternates row/column single-error correction until stable.
"""
from __future__ import annotations

import numpy as np

from .hamming import HAMMING_13_9_3, HAMMING_15_11_3

__all__ = ["bptc_196_96_encode", "bptc_196_96_decode"]

_DEINT = (181 * np.arange(196)) % 196


def _data_positions() -> np.ndarray:
    """Indices (into the deinterleaved 196) of the 96 info bits."""
    pos = []
    index = 4
    while index < 136:
        if (index % 15) < 12:
            pos.append(index)
            index += 1
        else:
            index += 4
    assert len(pos) == 96
    return np.asarray(pos)


_DATA_POS = _data_positions()


def bptc_196_96_encode(data: np.ndarray) -> np.ndarray:
    """96 info bits -> 196 interleaved on-air bits."""
    d = np.asarray(data, np.uint8)
    if len(d) != 96:
        raise ValueError("BPTC(196,96) expects 96 info bits")
    m = np.zeros(196, dtype=np.uint8)
    m[_DATA_POS] = d
    # matrix[r, c] = m[1 + 15r + c]
    mat = m[1:].reshape(13, 15)
    for r in range(9):
        mat[r] = HAMMING_15_11_3.encode(mat[r, :11])
    for c in range(15):
        mat[:, c] = HAMMING_13_9_3.encode(mat[:9, c])
    m[1:] = mat.reshape(-1)
    out = np.zeros(196, dtype=np.uint8)
    out[_DEINT] = m  # interleave: on-air[(181x)%196] = matrix[x]
    return out


def bptc_196_96_decode(bits: np.ndarray, max_iters: int = 3):
    """196 on-air bits -> (96 info bits, corrected_count | None)."""
    b = np.asarray(bits, np.uint8)
    if len(b) != 196:
        raise ValueError("BPTC(196,96) expects 196 bits")
    m = b[_DEINT].copy()
    mat = m[1:].reshape(13, 15)
    corrected = 0
    for _ in range(max_iters):
        # one batched Hamming pass over all 13 rows / 15 columns (the
        # scalar per-row loop dominated DMR bank framing; decode_batch
        # reports nerr -1 where uncorrectable)
        rows, r_err = HAMMING_15_11_3.decode_batch(mat)
        r_fix = r_err > 0
        clean = not np.any(r_err < 0)
        changed = bool(np.any(r_fix))
        mat[r_fix] = rows[r_fix]
        corrected += int(r_err[r_fix].sum())

        cols, c_err = HAMMING_13_9_3.decode_batch(mat.T)
        c_fix = c_err > 0
        clean = clean and not np.any(c_err < 0)
        changed = changed or bool(np.any(c_fix))
        mat.T[c_fix] = cols[c_fix]
        corrected += int(c_err[c_fix].sum())

        if clean and not changed:
            break
        if not changed and not clean:
            return m[_DATA_POS], None
    m[1:] = mat.reshape(-1)
    return m[_DATA_POS], corrected
