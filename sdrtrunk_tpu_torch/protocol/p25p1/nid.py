"""P25 network ID word: NAC(12) + DUID(4) protected by BCH(63,16,11) + 1
parity bit (P25P1DataUnitDetector.java:119-176).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import from_int, to_int
from ..edac.bch import BCH_63_16_11

__all__ = ["NID"]

_BCH = BCH_63_16_11()


@dataclass(frozen=True)
class NID:
    nac: int
    duid: int
    corrected: int = 0

    @staticmethod
    def encode(nac: int, duid: int) -> np.ndarray:
        """-> 64 bits (63 BCH + parity)."""
        data = np.concatenate([from_int(nac, 12), from_int(int(duid), 4)])
        return _BCH.encode(data)

    @staticmethod
    def decode(bits64: np.ndarray) -> "NID | None":
        data, nerr = _BCH.decode(bits64)
        if nerr is None:
            return None
        return NID(nac=to_int(data, 0, 12), duid=to_int(data, 12, 16),
                   corrected=nerr)
