"""P25 Phase 2 timeslot parsing: DUID, FACCH/SACCH (punctured RS(63,35)),
voice timeslots, MAC PDU typing.

Timeslot = 320 bits. DUID: 8 bits (4 value + 4 parity) at positions
{0,1,74,75,244,245,318,319} (timeslot/Timeslot.java). FACCH carries 26
info hexbits + 19 parity, SACCH 30 + 19; both are RS(63,35,29) codewords
with 9 parity symbols punctured (never transmitted) and the balance
shortened (FacchTimeslot/SacchTimeslot input maps). Hexbits are
interleaved around the DUID/sync gaps. Voice-4: 72-bit frames at
2/76/172/246 with ESS-B at 148 (Voice4Timeslot.java:37-43).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..bits import from_int, to_int
from ..edac.galois import GF64_P25
from ..edac.rs import ReedSolomon

__all__ = ["DataUnitID", "Timeslot", "timeslot_decode", "facch_encode",
           "sacch_encode", "voice4_encode", "MacPduType"]

_RS = ReedSolomon(63, 35, GF64_P25)
_PUNCTURED = 9          # untransmitted parity symbols
_PARITY_TX = 19

DUID_POSITIONS = np.array([0, 1, 74, 75, 244, 245, 318, 319])

# value-with-parity codebook (enumeration/DataUnitID.java)
_DUID_CODES = {
    0x00: "VOICE_4",
    0x39: "SACCH_SCRAMBLED",
    0x65: "VOICE_2",
    0x9A: "FACCH_SCRAMBLED",
    0xC6: "SACCH_UNSCRAMBLED",
    0xFF: "FACCH_UNSCRAMBLED",
}


class DataUnitID(enum.Enum):
    VOICE_4 = 0x00
    SACCH_SCRAMBLED = 0x39
    VOICE_2 = 0x65
    FACCH_SCRAMBLED = 0x9A
    SACCH_UNSCRAMBLED = 0xC6
    FACCH_UNSCRAMBLED = 0xFF

    @property
    def is_scrambled(self) -> bool:
        return self in (DataUnitID.VOICE_4, DataUnitID.VOICE_2,
                        DataUnitID.SACCH_SCRAMBLED,
                        DataUnitID.FACCH_SCRAMBLED)

    @property
    def is_voice(self) -> bool:
        return self in (DataUnitID.VOICE_4, DataUnitID.VOICE_2)

    @property
    def is_sacch(self) -> bool:
        return self in (DataUnitID.SACCH_SCRAMBLED,
                        DataUnitID.SACCH_UNSCRAMBLED)
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


class MacPduType(enum.Enum):
    RESERVED_0 = 0
    PTT = 1
    END_PTT = 2
    IDLE = 3
    ACTIVE = 4
    RESERVED_5 = 5
    HANGTIME = 6
    RESERVED_7 = 7
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


def _hexbit_positions(n_info: int) -> list[np.ndarray]:
    """Bit positions of each hexbit (info then parity), skipping the DUID
    gap positions 74-75 and 244-245 (sync gap 138-179 applies to FACCH)."""
    positions = []
    cursor = 2
    skip = {74, 75, 244, 245}
    if n_info == 26:                       # FACCH: also skip sync region
        skip |= set(range(138, 180))
    for _ in range(n_info + _PARITY_TX):
        bits = []
        while len(bits) < 6:
            if cursor not in skip:
                bits.append(cursor)
            cursor += 1
        positions.append(np.asarray(bits))
    return positions


_FACCH_POS = _hexbit_positions(26)
_SACCH_POS = _hexbit_positions(30)


def duid_decode(bits320: np.ndarray) -> tuple[DataUnitID | None, int]:
    code = to_int(bits320[DUID_POSITIONS])
    best, best_err = None, 9
    for value, _name in _DUID_CODES.items():
        err = bin(code ^ value).count("1")
        if err < best_err:
            best, best_err = DataUnitID(value), err
    if best_err > 2:
        return None, best_err
    return best, best_err


@dataclass(slots=True)
class Timeslot:
    duid: DataUnitID
    index: int                      # 0..11 within the superframe (if known)
    channel: int                    # 0/1 TDMA channel
    bits: np.ndarray                # descrambled 320 bits
    mac_pdu_type: MacPduType | None = None
    mac_octets: np.ndarray | None = None
    mac: object | None = None          # MacPdu once parsed (see mac.py)
    voice_frames: np.ndarray | None = None
    ess_b: np.ndarray | None = None
    rs_errors: int | None = None


def _rs_wire(info_hex: np.ndarray, parity_hex: np.ndarray,
             n_info: int) -> np.ndarray:
    shorten = 35 - n_info
    return np.concatenate([
        np.zeros(shorten, np.int64), info_hex,
        parity_hex, np.zeros(_PUNCTURED, np.int64)])


def _signaling_decode(bits320: np.ndarray, n_info: int,
                      positions) -> tuple[np.ndarray | None, int | None]:
    hexbits = np.array([to_int(bits320[p]) for p in positions], np.int64)
    info, parity = hexbits[:n_info], hexbits[n_info:]
    shorten = 35 - n_info
    # encode-check fast path: a clean word's re-encoded parity matches
    # the 19 TRANSMITTED symbols (the 9 punctured ones are never on
    # air, so the BM decoder sees >= 9 'errors' even on clean words —
    # rs.encode_parity docstring)
    padded = np.concatenate([np.zeros(shorten, np.int64), info])
    expected = _RS.encode_parity(padded)
    if np.array_equal(expected[:_PARITY_TX], parity):
        return np.concatenate(
            [from_int(int(h), 6) for h in info]), 0
    cw, nerr = _RS.decode(_rs_wire(info, parity, n_info))
    if nerr is None:
        return None, None
    info_bits = np.concatenate(
        [from_int(int(h), 6) for h in cw[shorten: 35]])
    # report CHANNEL errors: BM's count includes the 9 punctured
    # substitutions it always "corrects"
    return info_bits, max(int(nerr) - _PUNCTURED, 1)


def _signaling_encode(info_bits: np.ndarray, n_info: int,
                      positions, duid: DataUnitID) -> np.ndarray:
    info_hex = np.array([to_int(info_bits, 6 * i, 6 * i + 6)
                         for i in range(n_info)], np.int64)
    shorten = 35 - n_info
    cw = _RS.encode(np.concatenate([np.zeros(shorten, np.int64), info_hex]))
    parity = cw[35: 35 + _PARITY_TX]
    ts = np.zeros(320, dtype=np.uint8)
    hexbits = np.concatenate([info_hex, parity])
    for h, pos in zip(hexbits, positions):
        ts[pos] = from_int(int(h), 6)
    ts[DUID_POSITIONS] = from_int(duid.value, 8)
    return ts


def facch_encode(info_bits156: np.ndarray,
                 scrambled: bool = False) -> np.ndarray:
    duid = (DataUnitID.FACCH_SCRAMBLED if scrambled
            else DataUnitID.FACCH_UNSCRAMBLED)
    return _signaling_encode(np.asarray(info_bits156, np.uint8), 26,
                             _FACCH_POS, duid)


def sacch_encode(info_bits180: np.ndarray,
                 scrambled: bool = False) -> np.ndarray:
    duid = (DataUnitID.SACCH_SCRAMBLED if scrambled
            else DataUnitID.SACCH_UNSCRAMBLED)
    return _signaling_encode(np.asarray(info_bits180, np.uint8), 30,
                             _SACCH_POS, duid)


def voice4_encode(frames: np.ndarray, ess_b: np.ndarray | None = None,
                  ) -> np.ndarray:
    """4 x 72-bit voice frames (+24-bit ESS-B) -> 320-bit VOICE_4
    timeslot (pre-scrambling)."""
    f = np.asarray(frames, np.uint8).reshape(4, 72)
    ts = np.zeros(320, dtype=np.uint8)
    for frame, start in zip(f, (2, 76, 172, 246)):
        ts[start: start + 72] = frame
    if ess_b is not None:
        ts[148:172] = np.asarray(ess_b, np.uint8)
    ts[DUID_POSITIONS] = from_int(DataUnitID.VOICE_4.value, 8)
    return ts


def timeslot_decode(bits320: np.ndarray, index: int, channel: int,
                    scrambling_segment: np.ndarray | None = None
                    ) -> Timeslot | None:
    b = np.asarray(bits320, np.uint8)
    duid, _derr = duid_decode(b)
    if duid is None:
        return None
    if duid.is_scrambled and scrambling_segment is not None:
        b = b ^ np.asarray(scrambling_segment, np.uint8)
        b[DUID_POSITIONS] = np.asarray(bits320, np.uint8)[DUID_POSITIONS]
    ts = Timeslot(duid=duid, index=index, channel=channel, bits=b)
    if duid.is_voice:
        starts = ((2, 76, 172, 246) if duid == DataUnitID.VOICE_4
                  else (2, 76))
        ts.voice_frames = np.stack([b[s: s + 72] for s in starts])
        if duid == DataUnitID.VOICE_4:
            ts.ess_b = b[148:172]
    else:
        n_info = 30 if duid.is_sacch else 26
        positions = _SACCH_POS if duid.is_sacch else _FACCH_POS
        info_bits, nerr = _signaling_decode(b, n_info, positions)
        ts.rs_errors = nerr
        if info_bits is not None:
            ts.mac_octets = info_bits
            ts.mac_pdu_type = MacPduType(to_int(info_bits, 0, 3))
    return ts
