"""Inter-slot signalling channel (ISCH) codec: (40,9) linear block code
with a 40-bit XOR mask (message/InterSlotSignallingChannel.java — the
generator matrix and mask come from TIA-102.BBAC).

Word fields (MSB-first 9 bits): RESERVED(2) CHANNEL(2) ISCH_SEQUENCE(2)
ISCH_FREE(1) SUPERFRAME_SEQUENCE(2). Only the 128 words with reserved=00
occur; decode picks the minimum-Hamming-distance valid codeword.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..bits import from_int, to_int

__all__ = ["ISCH", "isch_encode", "isch_decode"]

_G = np.array([
    [1,0,0,0,1,0,0,0,0,0,0,1,0,1,1,0,1,1,0,0,1,1,1,0,0,0,1,1,0,1,1,0,1,1,0,1,0,1,1,1],
    [0,0,1,0,0,0,0,0,0,0,0,1,1,1,0,1,1,1,1,1,1,1,0,1,0,1,0,0,1,1,1,1,0,1,1,0,0,1,0,0],
    [0,0,0,1,0,0,0,0,0,0,0,0,1,1,1,1,0,1,0,0,1,0,1,1,0,0,0,1,0,1,1,1,0,1,0,1,1,0,0,0],
    [0,0,0,0,1,1,0,0,0,0,0,0,0,0,0,0,1,1,0,1,1,1,1,0,1,1,0,1,0,0,0,1,1,0,0,0,1,1,1,0],
    [0,0,0,0,0,0,1,0,0,0,0,0,1,0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,0,0,1,0,0,0,0,0,1,0,0,1,0,0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,1,1,1,0,0,1,0],
    [0,0,0,0,0,0,0,0,1,0,0,1,1,1,0,1,1,0,1,0,0,0,1,1,1,0,1,0,0,0,0,1,0,1,1,1,0,0,0,1],
    [0,0,0,0,0,0,0,0,0,1,0,1,1,0,0,0,1,1,0,0,1,0,1,1,1,0,1,0,1,0,1,0,0,1,0,0,1,1,1,0],
    [0,0,0,0,0,0,0,0,0,0,1,1,0,1,0,0,0,0,1,1,1,1,0,1,1,0,0,0,0,1,0,1,1,0,0,1,0,1,1,1],
], dtype=np.uint8)

_MASK = 0x184229D461


@lru_cache(maxsize=1)
def _codebook():
    """(128, 40) valid codewords for the 7-bit payloads (reserved = 0)."""
    words = np.zeros((128, 9), dtype=np.uint8)
    for x in range(128):
        words[x] = from_int(x, 9)
    cw = (words @ _G) % 2
    mask_bits = from_int(_MASK, 40)
    return (cw ^ mask_bits[None, :]).astype(np.uint8)


@dataclass(frozen=True)
class ISCH:
    channel: int              # timeslot-pair channel number 0/1
    isch_sequence: int        # 0=FRAG1 1=FRAG2 2=FRAG3 3=reserved
    inbound_free: bool
    superframe_sequence: int
    bit_errors: int = 0

    @property
    def timeslot_offset(self) -> int:
        return {0: 0, 1: 4, 2: 8}.get(self.isch_sequence, 0)

    @property
    def is_final_fragment(self) -> bool:
        return self.isch_sequence == 2


def isch_encode(channel: int, isch_sequence: int, inbound_free: bool,
                superframe_sequence: int) -> np.ndarray:
    value = ((channel & 3) << 5) | ((isch_sequence & 3) << 3) | \
        ((1 if inbound_free else 0) << 2) | (superframe_sequence & 3)
    return _codebook()[value]


def isch_decode(bits40: np.ndarray, max_errors: int = 8) -> ISCH | None:
    b = np.asarray(bits40, np.uint8)
    dists = (_codebook() ^ b[None, :]).sum(axis=1)
    best = int(np.argmin(dists))
    errors = int(dists[best])
    if errors > max_errors:
        return None
    word = from_int(best, 9)
    return ISCH(
        channel=to_int(word, 2, 4),
        isch_sequence=to_int(word, 4, 6),
        inbound_free=bool(word[6]),
        superframe_sequence=to_int(word, 7, 9),
        bit_errors=errors)
