"""MPT1327 trunking protocol (role of module/decode/mpt1327).

Codeword: 64 bits = 48 data + 15-bit cyclic checksum + 1 even-parity bit;
checksum uses the standard column table with initial value 1
(edac/CRCFleetsync.java — MPT1327 and Fleetsync share the code). Messages
start with a 16-bit sync (control 0xC4D7 / traffic 0xB52C, preceded by bit
reversals) followed by one or more 64-bit codewords
(MPT1327Message.java:30-39: block offsets 20, 84, 148, ...).

Message type is the 9-bit field at data bits 21..29 of an address word
(MPTMessageType.fromNumber — GTC for values < 256, the rest per the
MPT1327 specification numbering).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from .bits import from_int, to_bits, to_int, xor_popcount_correlate

__all__ = ["MPT1327Message", "MPT1327MessageType", "MPT1327Framer",
           "mpt_checksum", "mpt_encode_codeword", "mpt_decode_codeword",
           "SYNC_CONTROL", "SYNC_TRAFFIC"]

# 20-bit patterns = 4 trailing bit-reversals + 16-bit sync
# (bits/SyncPattern.java MPT1327_CONTROL / MPT1327_TRAFFIC)
SYNC_CONTROL = to_bits("10101100010011010111")
SYNC_TRAFFIC = to_bits("10100011101100101000")

CODEWORD_BITS = 64

# columns for data bits 0..47 (edac/CRCFleetsync.java sCHECKSUMS)
_COLUMNS = np.array([
    0x740A, 0x3A05, 0x6908, 0x3484, 0x1A42, 0x0D21, 0x729A, 0x394D,
    0x68AC, 0x3456, 0x1A2B, 0x791F, 0x4885, 0x5048, 0x2824, 0x1412,
    0x0A09, 0x710E, 0x3887, 0x6849, 0x402E, 0x2017, 0x6401, 0x460A,
    0x2305, 0x6588, 0x32C4, 0x1962, 0x0CB1, 0x7252, 0x3929, 0x689E,
    0x344F, 0x6E2D, 0x431C, 0x218E, 0x10C7, 0x7C69, 0x4A3E, 0x251F,
    0x6685, 0x4748, 0x23A4, 0x11D2, 0x08E9, 0x707E, 0x383F, 0x6815,
], dtype=np.int64)


class MPT1327MessageType(enum.Enum):
    GTC = "GTC"          # go to channel (call grant)
    ALH = "ALH"          # aloha
    ALHS = "ALHS"
    ALHD = "ALHD"
    ALHE = "ALHE"
    ALHR = "ALHR"
    ALHX = "ALHX"
    ALHF = "ALHF"
    ACK = "ACK"
    ACKI = "ACKI"
    ACKQ = "ACKQ"
    ACKX = "ACKX"
    ACKV = "ACKV"
    ACKE = "ACKE"
    ACKT = "ACKT"
    ACKB = "ACKB"
    AHOY = "AHOY"
    AHYX = "AHYX"
    AHYP = "AHYP"
    AHYQ = "AHYQ"
    AHYC = "AHYC"
    MARK = "MARK"
    MAINT = "MAINT"
    CLEAR = "CLEAR"
    MOVE = "MOVE"
    BCAST = "BCAST"
    SAMO = "SAMO"
    HEAD = "HEAD"
    GTT = "GTT"
    UNKNOWN = "UNKN"

    @staticmethod
    def from_number(value: int) -> "MPT1327MessageType":
        T = MPT1327MessageType
        if value < 256:
            return T.GTC
        exact = {256: T.ALH, 257: T.ALHS, 258: T.ALHD, 259: T.ALHE,
                 260: T.ALHR, 261: T.ALHX, 262: T.ALHF,
                 264: T.ACK, 265: T.ACKI, 266: T.ACKQ, 267: T.ACKX,
                 268: T.ACKV, 269: T.ACKE, 270: T.ACKT, 271: T.ACKB,
                 272: T.AHOY, 274: T.AHYX, 277: T.AHYP, 278: T.AHYQ,
                 279: T.AHYC, 280: T.MARK, 281: T.MAINT, 282: T.CLEAR,
                 283: T.MOVE, 284: T.BCAST}
        if value in exact:
            return exact[value]
        if 288 <= value <= 303:
            return T.SAMO
        if 304 <= value <= 319:
            return T.HEAD
        if 320 <= value <= 335:
            return T.GTT
        return T.UNKNOWN


def mpt_checksum(data48: np.ndarray) -> int:
    """15-bit checksum, initial value 1 (CRCFleetsync.check)."""
    b = np.asarray(data48, np.uint8)
    s = 1
    for pos in np.nonzero(b)[0]:
        s ^= int(_COLUMNS[pos])
    return s


def mpt_encode_codeword(data48: np.ndarray) -> np.ndarray:
    """48 data bits -> 64-bit codeword (checksum + even parity)."""
    d = np.asarray(data48, np.uint8)
    if len(d) != 48:
        raise ValueError("MPT1327 codeword takes 48 data bits")
    word = np.concatenate([d, from_int(mpt_checksum(d), 15),
                           np.zeros(1, np.uint8)])
    word[63] = word[:63].sum() % 2  # even parity
    return word


def mpt_decode_codeword(word64: np.ndarray) -> np.ndarray | None:
    w = np.asarray(word64, np.uint8)
    if len(w) != 64:
        raise ValueError("expected 64 bits")
    if int(w.sum()) % 2 != 0:
        return None
    if mpt_checksum(w[:48]) != to_int(w, 48, 63):
        return None
    return w[:48]


@dataclass
class MPT1327Message:
    message_type: MPT1327MessageType
    data: np.ndarray                 # 48 bits of the address codeword
    start: int = 0
    channel_type: str = "control"
    fields: dict = field(default_factory=dict)


def _parse_address_word(data: np.ndarray, start: int,
                        channel_type: str) -> MPT1327Message:
    """Field offsets are message-relative in the reference
    (MPT1327Message.java, BLOCK_1_START=20); data bit k = message bit 20+k."""
    tnum = to_int(data, 21, 30)
    mtype = MPT1327MessageType.from_number(tnum)
    msg = MPT1327Message(message_type=mtype, data=data, start=start,
                         channel_type=channel_type)
    prefix = to_int(data, 1, 8)
    ident1 = to_int(data, 8, 21)
    if mtype == MPT1327MessageType.GTC:
        msg.fields = {
            "prefix": prefix,
            "ident1": ident1,
            "channel": to_int(data, 21, 31),   # B1_TRAFFIC_CHANNEL region
            "ident2": to_int(data, 35, 48),
        }
    elif mtype in (MPT1327MessageType.ALH, MPT1327MessageType.ALHS,
                   MPT1327MessageType.ALHD, MPT1327MessageType.ALHE,
                   MPT1327MessageType.ALHR, MPT1327MessageType.ALHX,
                   MPT1327MessageType.ALHF):
        msg.fields = {"prefix": prefix, "ident1": ident1,
                      "aloha_number": to_int(data, 44, 48)}
    elif mtype == MPT1327MessageType.BCAST:
        msg.fields = {"sysdef": to_int(data, 1, 6),
                      "system_id": to_int(data, 6, 21)}
    else:
        msg.fields = {"prefix": prefix, "ident1": ident1}
    return msg


class MPT1327Framer:
    """Batch framer: find sync, validate + parse the following codeword."""

    def __init__(self, channel_type: str = "control",
                 max_sync_errors: int = 1):
        self.channel_type = channel_type
        self._sync = (SYNC_CONTROL if channel_type == "control"
                      else SYNC_TRAFFIC)
        self.max_sync_errors = max_sync_errors
        self._carry = np.zeros(0, np.uint8)
        self._offset = 0

    def process(self, bits: np.ndarray) -> list[MPT1327Message]:
        stream = np.concatenate([self._carry, np.asarray(bits, np.uint8)])
        base = self._offset
        msgs: list[MPT1327Message] = []
        errs = xor_popcount_correlate(stream, self._sync)
        consumed = 0
        for lag in np.nonzero(errs <= self.max_sync_errors)[0]:
            if lag < consumed:
                continue
            end = lag + len(self._sync) + CODEWORD_BITS
            if end > len(stream):
                break
            data = mpt_decode_codeword(
                stream[lag + len(self._sync): end])
            if data is not None:
                msgs.append(_parse_address_word(
                    data, base + int(lag), self.channel_type))
                consumed = int(end)
        keep = max(consumed, len(stream) - (len(self._sync) + CODEWORD_BITS))
        self._carry = stream[keep:]
        self._offset = base + keep
        return msgs
