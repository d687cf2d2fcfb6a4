"""DMR burst sub-structures: CACH (TACT + payload), SlotType, EMB.

Burst geometry (ETSI TS 102 361-1 4.2.2; offsets as in the reference's
DMRBurstFramer/SlotType/CACH classes, measured in bits of the 288-bit
CACH-inclusive burst):

  [0:24)    CACH (interleaved TACT + short-LC payload fragment)
  [24:132)  payload 1 (108)
  [132:180) sync or EMB+embedded-LC
  [180:288) payload 2 (108)

Data bursts: BPTC 196 info bits at [24:122) + [190:288); SlotType 20 bits
at [122:132) + [180:190) — a shortened Golay(20,8) carrying color code +
data type. Voice bursts use the full 108+108 for three 72-bit AMBE frames.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import from_int, to_int
from ..edac.golay import golay24_decode, golay24_decode_batch, golay24_encode
from ..edac.hamming import HammingCode

__all__ = ["CACH", "SlotType", "EMB", "BURST_BITS", "CACH_BITS",
           "cach_interleave", "cach_deinterleave", "cach_decode_batch",
           "slot_type_decode_batch", "emb_decode_batch"]

BURST_BITS = 288
CACH_BITS = 24

# decoded-order -> raw-order map (CACH.java INTERLEAVE_MATRIX)
_CACH_MATRIX = np.array([0, 4, 8, 12, 14, 18, 22, 1, 2, 3, 5, 6, 7, 9, 10,
                         11, 13, 15, 16, 17, 19, 20, 21, 23])

# TACT Hamming(7,4) columns (CACH.java CHECKSUMS)
_TACT_CODE = HammingCode("TACT(7,4)", 7, 4, [5, 7, 6, 3])

# EMB (16,7,6) quadratic-residue parity columns (EMB.java CRC_CHECKSUMS)
_EMB_CODE = HammingCode("EMB(16,7)", 16, 7,
                        [0x02F, 0x11E, 0x1B7, 0x1E2, 0x1C9, 0x0E5, 0x073])


def cach_deinterleave(raw24: np.ndarray) -> np.ndarray:
    return np.asarray(raw24, np.uint8)[_CACH_MATRIX]


def cach_interleave(decoded24: np.ndarray) -> np.ndarray:
    out = np.zeros(24, dtype=np.uint8)
    out[_CACH_MATRIX] = np.asarray(decoded24, np.uint8)
    return out


@dataclass(slots=True)
class CACH:
    busy: bool            # inbound channel access type
    timeslot: int         # 1 or 2 (outbound burst timeslot)
    lcss: int             # link control start/stop (2 bits)
    payload: np.ndarray   # 17-bit short-LC fragment
    valid: bool

    @staticmethod
    def decode(raw24: np.ndarray) -> "CACH":
        d = cach_deinterleave(raw24)
        tact = d[:7].astype(np.uint8)
        corrected, nerr = _TACT_CODE.decode(tact)
        return CACH(
            busy=bool(corrected[0]),
            timeslot=2 if corrected[1] else 1,
            lcss=to_int(corrected, 2, 4),
            payload=d[7:24],
            valid=nerr is not None,
        )

    @staticmethod
    def encode(busy: bool, timeslot: int, lcss: int,
               payload17: np.ndarray | None = None) -> np.ndarray:
        data = np.array([int(busy), 1 if timeslot == 2 else 0,
                         (lcss >> 1) & 1, lcss & 1], np.uint8)
        tact = _TACT_CODE.encode(data)
        payload = (np.zeros(17, np.uint8) if payload17 is None
                   else np.asarray(payload17, np.uint8))
        return cach_interleave(np.concatenate([tact, payload]))


@dataclass(slots=True)
class SlotType:
    color_code: int
    data_type: int
    valid: bool
    corrected: int = 0

    @staticmethod
    def decode(bits20: np.ndarray) -> "SlotType":
        """20 bits (SlotType.java: shortened Golay(20,8), 4 leading zero
        data bits)."""
        word = np.concatenate([np.zeros(4, np.uint8),
                               np.asarray(bits20, np.uint8)])
        corrected, nerr = golay24_decode(word)
        ok = nerr is not None and nerr < 3
        src = corrected if nerr is not None else word
        return SlotType(color_code=to_int(src, 4, 8),
                        data_type=to_int(src, 8, 12),
                        valid=ok, corrected=nerr or 0)

    @staticmethod
    def encode(color_code: int, data_type: int) -> np.ndarray:
        data = np.concatenate([np.zeros(4, np.uint8),
                               from_int(color_code, 4),
                               from_int(data_type, 4)])
        return golay24_encode(data)[4:]


@dataclass(slots=True)
class EMB:
    color_code: int
    pi: bool
    lcss: int
    valid: bool

    @staticmethod
    def decode(bits16: np.ndarray) -> "EMB":
        w = np.asarray(bits16, np.uint8)
        corrected, nerr = _EMB_CODE.decode(w)
        ok = nerr is not None
        src = corrected if ok else w
        return EMB(color_code=to_int(src, 0, 4), pi=bool(src[4]),
                   lcss=to_int(src, 5, 7), valid=ok)

    @staticmethod
    def encode(color_code: int, pi: bool, lcss: int) -> np.ndarray:
        data = np.concatenate([from_int(color_code, 4),
                               np.array([int(pi)], np.uint8),
                               from_int(lcss, 2)])
        return _EMB_CODE.encode(data)


# ---------------------------------------------------------------- batch
# Vectorized versions of the three per-burst decodes above — one batched
# syndrome pass for a whole chunk's bursts instead of ~14k scalar calls
# (the measured 1000-carrier DMR framing bottleneck). Field-for-field
# identical to the scalar decode() paths (asserted in tests/test_dmr
# _bankframer.py equivalence suites).

# intern tables for the batch decoders' value-type outputs
_ST_INTERN: dict[int, SlotType] = {}
_EMB_INTERN: dict[int, EMB] = {}


def cach_decode_batch(raw24: np.ndarray) -> list[CACH]:
    """(N, 24) interleaved CACH blocks -> N CACH objects."""
    d = np.asarray(raw24, np.uint8)[:, _CACH_MATRIX]
    tact, nerr = _TACT_CODE.decode_batch(d[:, :7])
    pay = d[:, 7:24]
    tl = tact[:, :4].tolist()               # plain ints: np scalar
    vl = (nerr >= 0).tolist()               # indexing is ~10x slower
    return [CACH(busy=bool(t[0]), timeslot=2 if t[1] else 1,
                 lcss=(t[2] << 1) | t[3], payload=pay[i], valid=vl[i])
            for i, t in enumerate(tl)]


def slot_type_decode_batch(bits20: np.ndarray) -> list[SlotType]:
    """(N, 20) slot-type words -> N SlotType objects."""
    b = np.asarray(bits20, np.uint8)
    words = np.concatenate(
        [np.zeros((len(b), 4), np.uint8), b], axis=1)
    out, nerr = golay24_decode_batch(words)
    pw4 = (1 << (3 - np.arange(4))).astype(np.int64)
    # intern: SlotType is a pure value type with a small key space
    # (color code, data type, validity, corrected count) — thousands of
    # repeat constructions per chunk at bank scale collapse to dict hits
    keys = ((out[:, 4:8] @ pw4) * 128 + (out[:, 8:12] @ pw4) * 8
            + np.clip(nerr, -1, 6) + 1).tolist()
    interned = _ST_INTERN
    res = []
    for k in keys:
        st = interned.get(k)
        if st is None:
            nl = (k & 7) - 1
            st = SlotType(color_code=k >> 7, data_type=(k >> 3) & 15,
                          valid=0 <= nl < 3, corrected=max(nl, 0))
            interned[k] = st
        res.append(st)
    return res


def emb_decode_batch(bits16: np.ndarray) -> list[EMB]:
    """(N, 16) EMB words -> N EMB objects (interned: 512 possible
    values, ~15k constructions/chunk at bank scale collapse to dict
    hits)."""
    w = np.asarray(bits16, np.uint8)
    out, nerr = _EMB_CODE.decode_batch(w)
    pw4 = (1 << (3 - np.arange(4))).astype(np.int64)
    keys = ((out[:, 0:4] @ pw4) * 32
            + out[:, 4].astype(np.int64) * 16
            + (out[:, 5].astype(np.int64) * 2 + out[:, 6]) * 4
            + (nerr >= 0) * 1).tolist()
    interned = _EMB_INTERN
    res = []
    for k in keys:
        e = interned.get(k)
        if e is None:
            e = EMB(color_code=k >> 5, pi=bool(k & 16),
                    lcss=(k >> 2) & 3, valid=bool(k & 1))
            interned[k] = e
        res.append(e)
    return res
