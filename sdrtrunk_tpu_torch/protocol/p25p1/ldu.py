"""P25 logical link data units LDU1/LDU2 (voice frames + link control).

Layout of the 1568 payload bits (TIA-102.BAAA; offsets match the
reference's LDU1Message.java GOLAY_WORD_STARTS / LDUMessage voice frame
slices):

  [0:144)   VC1        [144:288)  VC2
  [288:328)  LC hexbits 0-3    [328:472)  VC3
  [472:512)  LC hexbits 4-7    [512:656)  VC4
  [656:696)  LC hexbits 8-11   [696:840)  VC5
  [840:880)  LC hexbits 12-15  [880:1024) VC6
  [1024:1064) LC hexbits 16-19 [1064:1208) VC7
  [1208:1248) LC hexbits 20-23 [1248:1392) VC8
  [1392:1424) LSD (32)         [1424:1568) VC9

Each LC hexbit is Hamming(10,6,3)-coded; the 24 hexbits form an RS(24,12,13)
codeword for LDU1 (72-bit link control) or RS(24,16,9) for LDU2 (96-bit
encryption sync: MI 72 + ALGID 8 + KID 16).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import from_int, to_int
from ..edac.galois import GF64_P25
from ..edac.hamming import HAMMING_10_6_3
from ..edac.rs import ReedSolomon
from .lc import LinkControl, lc_parse

__all__ = ["LDU1", "LDU2", "ldu1_encode", "ldu1_decode", "ldu2_encode",
           "ldu2_decode", "ldu1_decode_batch", "ldu2_decode_batch",
           "VOICE_OFFSETS", "LC_GROUP_OFFSETS"]

VOICE_OFFSETS = [0, 144, 328, 512, 696, 880, 1064, 1248, 1424]
LC_GROUP_OFFSETS = [288, 472, 656, 840, 1024, 1208]  # 4 hexbits each

_RS_24_12 = ReedSolomon(24, 12, GF64_P25)
_RS_24_16 = ReedSolomon(24, 16, GF64_P25)


@dataclass
class LDU1:
    link_control: LinkControl | None
    voice_frames: np.ndarray     # (9, 144) raw IMBE frames
    lsd: np.ndarray              # 32 bits
    corrected: int = 0


@dataclass
class LDU2:
    message_indicator: np.ndarray | None   # 72 bits
    algorithm_id: int | None
    key_id: int | None
    voice_frames: np.ndarray
    lsd: np.ndarray
    corrected: int = 0

    @property
    def encrypted(self) -> bool:
        return self.algorithm_id is not None and self.algorithm_id != 0x80


def _hexbits_to_payload(hexbits24: np.ndarray, voice_frames: np.ndarray,
                        lsd: np.ndarray) -> np.ndarray:
    """Assemble the 1568-bit payload from 24 coded hexbits + voice + LSD."""
    payload = np.zeros(1568, dtype=np.uint8)
    for vf, off in zip(voice_frames, VOICE_OFFSETS):
        payload[off: off + 144] = vf
    for g, goff in enumerate(LC_GROUP_OFFSETS):
        for j in range(4):
            hex_val = int(hexbits24[4 * g + j])
            coded = HAMMING_10_6_3.encode(from_int(hex_val, 6))
            payload[goff + 10 * j: goff + 10 * j + 10] = coded
    payload[1392:1424] = lsd
    return payload


# (24, 10) bit positions of the coded LC hexbit words in the payload
_LC_WORD_POS = np.array([goff + 10 * j + np.arange(10)
                         for goff in LC_GROUP_OFFSETS
                         for j in range(4)])
_HEX_W = (1 << (5 - np.arange(6))).astype(np.int64)


def _payload_to_hexbits(payload: np.ndarray):
    """-> (24 hexbit values, hamming_corrected_bits); one batched
    Hamming(10,6,3) decode over all 24 words."""
    words = payload[_LC_WORD_POS]                       # (24, 10)
    dec, nerr = HAMMING_10_6_3.decode_batch(words)
    hexbits = dec[:, :6].astype(np.int64) @ _HEX_W
    return hexbits, int(nerr[nerr > 0].sum())


def _hexbits_batch(payloads: np.ndarray):
    """(N, 1568) -> (hexbits (N, 24), hamming_corrected (N,))."""
    words = payloads[:, _LC_WORD_POS]                   # (N, 24, 10)
    dec, nerr = HAMMING_10_6_3.decode_batch(words)
    hexbits = dec[..., :6].astype(np.int64) @ _HEX_W
    return hexbits, np.where(nerr > 0, nerr, 0).sum(axis=1)


def _hex_to_bits(hexvals: np.ndarray) -> np.ndarray:
    """(k,) hexbit values -> (6k,) bits."""
    return ((np.asarray(hexvals, np.int64)[:, None]
             >> (5 - np.arange(6))[None, :]) & 1
            ).astype(np.uint8).reshape(-1)


def ldu1_encode(lc_bits72: np.ndarray, voice_frames: np.ndarray,
                lsd: np.ndarray | None = None) -> np.ndarray:
    lc_bits72 = np.asarray(lc_bits72, np.uint8)
    if len(lc_bits72) != 72:
        raise ValueError("LDU1 link control must be 72 bits")
    data_hex = np.array([to_int(lc_bits72, 6 * i, 6 * i + 6)
                         for i in range(12)], np.int64)
    hexbits = _RS_24_12.encode(data_hex)
    lsd = np.zeros(32, np.uint8) if lsd is None else np.asarray(lsd, np.uint8)
    return _hexbits_to_payload(hexbits, np.asarray(voice_frames, np.uint8),
                               lsd)


def ldu1_decode(payload: np.ndarray) -> LDU1:
    p = np.asarray(payload, np.uint8)
    if len(p) != 1568:
        raise ValueError("LDU1 payload must be 1568 bits")
    hexbits, ham_err = _payload_to_hexbits(p)
    corrected_cw, rs_err = _RS_24_12.decode(hexbits)
    lc = None
    corrected = ham_err
    if rs_err is not None:
        corrected += rs_err
        lc_bits = np.concatenate(
            [from_int(int(h), 6) for h in corrected_cw[:12]])
        lc = lc_parse(lc_bits)
    voice = np.stack([p[off: off + 144] for off in VOICE_OFFSETS])
    return LDU1(link_control=lc, voice_frames=voice, lsd=p[1392:1424],
                corrected=corrected)


def ldu2_encode(mi_bits72: np.ndarray, algorithm_id: int, key_id: int,
                voice_frames: np.ndarray,
                lsd: np.ndarray | None = None) -> np.ndarray:
    mi = np.asarray(mi_bits72, np.uint8)
    if len(mi) != 72:
        raise ValueError("message indicator must be 72 bits")
    data_bits = np.concatenate(
        [mi, from_int(algorithm_id, 8), from_int(key_id, 16)])
    data_hex = np.array([to_int(data_bits, 6 * i, 6 * i + 6)
                         for i in range(16)], np.int64)
    hexbits = _RS_24_16.encode(data_hex)
    lsd = np.zeros(32, np.uint8) if lsd is None else np.asarray(lsd, np.uint8)
    return _hexbits_to_payload(hexbits, np.asarray(voice_frames, np.uint8),
                               lsd)


_LC_CACHE: dict[bytes, object] = {}


def _lc_cached(cw12: np.ndarray):
    """lc_parse with memoization: the SAME link control repeats on every
    LDU1 of a call, so at 1000-channel scale re-parsing it per frame is
    pure overhead. Keyed by the 12 corrected hexbits."""
    key = cw12.tobytes()
    lc = _LC_CACHE.get(key)
    if lc is None:
        if len(_LC_CACHE) > 4096:
            _LC_CACHE.clear()
        lc = lc_parse(_hex_to_bits(cw12))
        _LC_CACHE[key] = lc
    return lc


def ldu1_decode_batch(payloads: np.ndarray) -> list[LDU1]:
    """Vectorized ldu1_decode over (N, 1568) payloads — the bank framer's
    hot path at 1000-channel scale. RS error correction falls back to the
    scalar decoder only for words with nonzero syndromes (rare on a live
    signal); results are identical to ldu1_decode row by row."""
    p = np.asarray(payloads, np.uint8).reshape(-1, 1568)
    if p.shape[0] == 0:
        return []
    hexbits, ham = _hexbits_batch(p)
    synd_ok = ~np.any(_RS_24_12.syndromes(hexbits), axis=1)
    voice = p[:, np.add.outer(np.asarray(VOICE_OFFSETS), np.arange(144))]
    out = []
    for i in range(len(p)):
        if synd_ok[i]:
            cw, rs_err = hexbits[i], 0
        else:
            cw, rs_err = _RS_24_12.decode(hexbits[i])
        lc = None
        corrected = int(ham[i])
        if rs_err is not None:
            corrected += rs_err
            lc = _lc_cached(cw[:12])
        out.append(LDU1(link_control=lc, voice_frames=voice[i],
                        lsd=p[i, 1392:1424], corrected=corrected))
    return out


def ldu2_decode_batch(payloads: np.ndarray) -> list[LDU2]:
    """Vectorized ldu2_decode over (N, 1568) payloads (see
    ldu1_decode_batch)."""
    p = np.asarray(payloads, np.uint8).reshape(-1, 1568)
    if p.shape[0] == 0:
        return []
    hexbits, ham = _hexbits_batch(p)
    synd_ok = ~np.any(_RS_24_16.syndromes(hexbits), axis=1)
    voice = p[:, np.add.outer(np.asarray(VOICE_OFFSETS), np.arange(144))]
    out = []
    for i in range(len(p)):
        if synd_ok[i]:
            cw, rs_err = hexbits[i], 0
        else:
            cw, rs_err = _RS_24_16.decode(hexbits[i])
        mi = algid = kid = None
        corrected = int(ham[i])
        if rs_err is not None:
            corrected += rs_err
            data_bits = _hex_to_bits(cw[:16])
            mi = data_bits[:72]
            algid = to_int(data_bits, 72, 80)
            kid = to_int(data_bits, 80, 96)
        out.append(LDU2(message_indicator=mi, algorithm_id=algid,
                        key_id=kid, voice_frames=voice[i],
                        lsd=p[i, 1392:1424], corrected=corrected))
    return out


def ldu2_decode(payload: np.ndarray) -> LDU2:
    p = np.asarray(payload, np.uint8)
    if len(p) != 1568:
        raise ValueError("LDU2 payload must be 1568 bits")
    hexbits, ham_err = _payload_to_hexbits(p)
    corrected_cw, rs_err = _RS_24_16.decode(hexbits)
    mi = algid = kid = None
    corrected = ham_err
    if rs_err is not None:
        corrected += rs_err
        data_bits = np.concatenate(
            [from_int(int(h), 6) for h in corrected_cw[:16]])
        mi = data_bits[:72]
        algid = to_int(data_bits, 72, 80)
        kid = to_int(data_bits, 80, 96)
    voice = np.stack([p[off: off + 144] for off in VOICE_OFFSETS])
    return LDU2(message_indicator=mi, algorithm_id=algid, key_id=kid,
                voice_frames=voice, lsd=p[1392:1424], corrected=corrected)
