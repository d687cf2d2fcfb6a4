"""P25 header data unit (HDU) + terminator with link control (TDULC).

HDU (TIA-102.BAAA; reference message/hdu/HDUMessage.java): 648 payload bits
= 36 Golay(18,6,8) codewords -> 36 hexbits forming an RS(36,20,17) codeword;
the 20 data hexbits carry MI(72) MFID(8) ALGID(8) KID(16) TGID(16).
10 trailing null bits pad the payload to 658.

TDULC (message/tdulc/TDULinkControlMessage.java): 308 payload bits = 12
Golay(24,12,8) codewords -> 24 hexbits forming the same RS(24,12,13)-coded
72-bit link control as LDU1, + 20 trailing nulls.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import from_int, to_int
from ..edac.galois import GF64_P25
from ..edac.golay import (golay18_decode, golay18_encode, golay24_decode,
                          golay24_encode)
from ..edac.rs import ReedSolomon
from .lc import LinkControl, lc_parse

__all__ = ["HDU", "hdu_encode", "hdu_decode", "tdulc_encode", "tdulc_decode"]

_RS_36_20 = ReedSolomon(36, 20, GF64_P25)
_RS_24_12 = ReedSolomon(24, 12, GF64_P25)


@dataclass
class HDU:
    message_indicator: np.ndarray  # 72 bits
    mfid: int
    algorithm_id: int
    key_id: int
    talkgroup: int
    corrected: int = 0

    @property
    def encrypted(self) -> bool:
        return self.algorithm_id != 0x80


def hdu_encode(mi_bits72: np.ndarray, mfid: int, algorithm_id: int,
               key_id: int, talkgroup: int) -> np.ndarray:
    """-> 658 payload bits (648 coded + 10 nulls)."""
    mi = np.asarray(mi_bits72, np.uint8)
    if len(mi) != 72:
        raise ValueError("message indicator must be 72 bits")
    data_bits = np.concatenate([
        mi, from_int(mfid, 8), from_int(algorithm_id, 8),
        from_int(key_id, 16), from_int(talkgroup, 16)])
    data_hex = np.array([to_int(data_bits, 6 * i, 6 * i + 6)
                         for i in range(20)], np.int64)
    hexbits = _RS_36_20.encode(data_hex)
    payload = np.zeros(658, dtype=np.uint8)
    for i, h in enumerate(hexbits):
        payload[18 * i: 18 * i + 18] = golay18_encode(from_int(int(h), 6))
    return payload


def hdu_decode(payload: np.ndarray) -> HDU | None:
    p = np.asarray(payload, np.uint8)
    if len(p) not in (648, 658):
        raise ValueError("HDU payload must be 648 or 658 bits")
    hexbits = np.zeros(36, dtype=np.int64)
    corrected = 0
    for i in range(36):
        word, nerr = golay18_decode(p[18 * i: 18 * i + 18])
        if nerr:
            corrected += nerr or 0
        hexbits[i] = to_int(word, 0, 6)
    cw, rs_err = _RS_36_20.decode(hexbits)
    if rs_err is None:
        return None
    corrected += rs_err
    data_bits = np.concatenate([from_int(int(h), 6) for h in cw[:20]])
    return HDU(
        message_indicator=data_bits[:72],
        mfid=to_int(data_bits, 72, 80),
        algorithm_id=to_int(data_bits, 80, 88),
        key_id=to_int(data_bits, 88, 104),
        talkgroup=to_int(data_bits, 104, 120),
        corrected=corrected,
    )


def tdulc_encode(lc_bits72: np.ndarray) -> np.ndarray:
    """-> 308 payload bits (288 coded + 20 nulls)."""
    lc = np.asarray(lc_bits72, np.uint8)
    if len(lc) != 72:
        raise ValueError("link control must be 72 bits")
    data_hex = np.array([to_int(lc, 6 * i, 6 * i + 6) for i in range(12)],
                        np.int64)
    hexbits = _RS_24_12.encode(data_hex)
    payload = np.zeros(308, dtype=np.uint8)
    for w in range(12):
        pair = np.concatenate([from_int(int(hexbits[2 * w]), 6),
                               from_int(int(hexbits[2 * w + 1]), 6)])
        payload[24 * w: 24 * w + 24] = golay24_encode(pair)
    return payload


def tdulc_decode(payload: np.ndarray) -> LinkControl | None:
    p = np.asarray(payload, np.uint8)
    if len(p) not in (288, 308):
        raise ValueError("TDULC payload must be 288 or 308 bits")
    hexbits = np.zeros(24, dtype=np.int64)
    for w in range(12):
        word, nerr = golay24_decode(p[24 * w: 24 * w + 24])
        hexbits[2 * w] = to_int(word, 0, 6)
        hexbits[2 * w + 1] = to_int(word, 6, 12)
    cw, rs_err = _RS_24_12.decode(hexbits)
    if rs_err is None:
        return None
    lc_bits = np.concatenate([from_int(int(h), 6) for h in cw[:12]])
    return lc_parse(lc_bits)
