"""Bit-array utilities: the role of the reference's BinaryMessage
(bits/BinaryMessage.java:30) and CorrectedBinaryMessage
(bits/CorrectedBinaryMessage.java:26), re-based on NumPy uint8 0/1 arrays.

Unlike the reference's BitSet subclass (sparse, per-bit set/get), messages
here are dense arrays so field extraction is slicing + a dot with powers of
two, and whole batches of messages can be processed at once.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "to_bits", "from_int", "to_int", "bits_to_hex", "hex_to_bits",
    "dibits_to_bits", "bits_to_dibits", "pack_bits", "unpack_bits",
    "xor_popcount_correlate",
]


def to_bits(value, width: int | None = None) -> np.ndarray:
    """Coerce to a uint8 0/1 array. Accepts int (+width), str of 0/1,
    list/array."""
    if isinstance(value, (int, np.integer)):
        if width is None:
            raise ValueError("width required for int -> bits")
        return from_int(int(value), width)
    if isinstance(value, str):
        return np.frombuffer(value.encode(), dtype=np.uint8) - ord("0")
    arr = np.asarray(value)
    return (arr != 0).astype(np.uint8)


def from_int(value: int, width: int) -> np.ndarray:
    """MSB-first bits of `value` in `width` bits."""
    if value < 0 or (width < 64 and value >= (1 << width)):
        raise ValueError(f"value {value} does not fit in {width} bits")
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.uint8)


def to_int(bits: np.ndarray, start: int = 0, stop: int | None = None) -> int:
    """MSB-first integer from bits[start:stop] (mirrors
    BinaryMessage.getInt(start, end) with end exclusive here).

    tolist + shift-accumulate is the fastest form for the short fields
    message parsing reads (~0.7 us vs ~3.4 for a dtype-cast dot); this
    is one of the hottest host calls at 1000-channel scale."""
    seg = bits[start:stop]
    values = seg.tolist() if isinstance(seg, np.ndarray) else seg
    out = 0
    for b in values:
        out = (out << 1) | int(b)
    return out


def bits_to_hex(bits: np.ndarray) -> str:
    """Hex string (MSB-first, left-padded to nibble)."""
    bits = np.asarray(bits)
    pad = (-len(bits)) % 4
    if pad:
        bits = np.concatenate([np.zeros(pad, np.uint8), bits])
    val = to_int(bits)
    return f"{val:0{len(bits) // 4}X}"


def hex_to_bits(hexstr: str, width: int | None = None) -> np.ndarray:
    bits = from_int(int(hexstr, 16), 4 * len(hexstr))
    if width is not None:
        if width < len(bits):
            bits = bits[len(bits) - width:]
        elif width > len(bits):
            bits = np.concatenate([np.zeros(width - len(bits), np.uint8), bits])
    return bits


def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    """Dibit values 0..3 -> bit pairs, MSB first (Dibit.java mapping:
    0->00, 1->01, 2->10, 3->11)."""
    d = np.asarray(dibits, dtype=np.uint8)
    out = np.empty(2 * len(d), dtype=np.uint8)
    out[0::2] = (d >> 1) & 1
    out[1::2] = d & 1
    return out


def bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    b = np.asarray(bits, dtype=np.uint8)
    if len(b) % 2:
        raise ValueError("bit count must be even")
    return (b[0::2] << 1) | b[1::2]


def pack_bits(bits: np.ndarray) -> bytes:
    """MSB-first byte packing."""
    b = np.asarray(bits, np.uint8)
    pad = (-len(b)) % 8
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    return np.packbits(b).tobytes()


def unpack_bits(data: bytes, count: int | None = None) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    return bits[:count] if count is not None else bits


def xor_popcount_correlate(bits: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Bit-error count of `pattern` against every alignment of `bits`.

    out[i] = popcount(bits[i:i+P] XOR pattern); vectorized over all lags —
    the batched equivalent of the reference's per-dibit soft sync detectors
    (bits/SoftSyncDetector.java:21, bits/MultiSyncPatternMatcher.java:42).
    """
    bits = np.asarray(bits, np.uint8)
    pattern = np.asarray(pattern, np.uint8)
    n, p = len(bits), len(pattern)
    if n < p:
        return np.zeros((0,), np.int32)
    # correlation of +/-1 sequences: errors = (P - dot)/2
    x = 1.0 - 2.0 * bits.astype(np.float32)
    h = 1.0 - 2.0 * pattern.astype(np.float32)
    dot = np.correlate(x, h, mode="valid")
    return np.rint((p - dot) / 2.0).astype(np.int32)
