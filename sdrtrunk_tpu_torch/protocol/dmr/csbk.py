"""DMR control signalling block (CSBK) codec + common opcode parsing.

Wire: 196 BPTC(196,96)-coded bits -> 96 bits = LB(1) PF(1) CSBKO(6) FID(8)
data(64) CRC-CCITT(16, mask 0xA5A5) (ETSI TS 102 361-1/-4; reference
message/data/csbk/CSBKMessage.java and standard/ subclasses).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bits import from_int, to_int
from ..edac.bptc import bptc_196_96_decode, bptc_196_96_encode
from ..edac.crc import DMR_MASK_CSBK, check_crc16_ccitt, crc16_ccitt

__all__ = ["CSBK", "csbk_encode", "csbk_decode", "CSBKO_NAMES"]

# opcode -> name per the reference's standard table
# (message/data/csbk/Opcode.java:37-68, ETSI TS 102 361-2/4 CSBKO)
CSBKO_NAMES = {
    0x03: "FEATURE_NOT_SUPPORTED",
    0x04: "UNIT_TO_UNIT_VOICE_SERVICE_REQUEST",
    0x05: "UNIT_TO_UNIT_VOICE_SERVICE_RESPONSE",
    0x07: "CHANNEL_TIMING",
    0x19: "ALOHA",
    0x1A: "UDT_OUTBOUND_HEADER",
    0x1B: "UDT_INBOUND_HEADER",
    0x1C: "AHOY",
    0x1E: "ACTIVATION",
    0x1F: "RANDOM_ACCESS_SERVICE_REQUEST",
    0x20: "ACKNOWLEDGE_RESPONSE_OUTBOUND_TSCC",
    0x21: "ACKNOWLEDGE_RESPONSE_INBOUND_TSCC",
    0x22: "ACKNOWLEDGE_RESPONSE_OUTBOUND_PAYLOAD",
    0x23: "ACKNOWLEDGE_RESPONSE_INBOUND_PAYLOAD",
    0x24: "UDT_DGNA_OUTBOUND_HEADER",
    0x25: "UDT_DGNA_INBOUND_HEADER",
    0x26: "NEGATIVE_ACKNOWLEDGE_RESPONSE",
    0x28: "ANNOUNCEMENT",
    0x2A: "MAINTENANCE",
    0x2E: "CLEAR",
    0x2F: "PROTECT",
    0x30: "PRIVATE_VOICE_CHANNEL_GRANT",
    0x31: "TALKGROUP_VOICE_CHANNEL_GRANT",
    0x32: "BROADCAST_TALKGROUP_VOICE_CHANNEL_GRANT",
    0x33: "PRIVATE_DATA_CHANNEL_GRANT_SINGLE_ITEM",
    0x34: "TALKGROUP_DATA_CHANNEL_GRANT_SINGLE_ITEM",
    0x35: "DUPLEX_PRIVATE_VOICE_CHANNEL_GRANT",
    0x36: "DUPLEX_PRIVATE_DATA_CHANNEL_GRANT",
    0x37: "PRIVATE_DATA_CHANNEL_GRANT_MULTI_ITEM",
    0x38: "TALKGROUP_DATA_CHANNEL_GRANT_MULTI_ITEM",
    0x39: "MOVE_TSCC",
    0x3D: "PREAMBLE",
}


@dataclass
class CSBK:
    last_block: bool
    protected: bool
    opcode: int
    fid: int
    data: np.ndarray           # 64 bits
    corrected: int = 0
    fields: dict = field(default_factory=dict)

    @property
    def opcode_name(self) -> str:
        if self.fid != 0:
            from .csbk_vendor import vendor_csbk_name
            name = vendor_csbk_name(self.fid, self.opcode)
            if name is not None:
                return name
            return f"FID_{self.fid:02X}_CSBKO_{self.opcode:02X}"
        return CSBKO_NAMES.get(self.opcode, f"CSBKO_{self.opcode:02X}")

    @property
    def known(self) -> bool:
        """Opcode resolved to a named structure (coverage counter)."""
        if self.fid != 0:
            from .csbk_vendor import vendor_csbk_name
            return vendor_csbk_name(self.fid, self.opcode) is not None
        return self.opcode in CSBKO_NAMES


def csbk_encode(opcode: int, data: np.ndarray, fid: int = 0,
                last_block: bool = True) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    if len(data) != 64:
        raise ValueError("CSBK data must be 64 bits")
    body = np.concatenate([
        np.array([int(last_block), 0], np.uint8),
        from_int(opcode, 6), from_int(fid, 8), data])
    crc = crc16_ccitt(body, xor_out=0) ^ DMR_MASK_CSBK
    return bptc_196_96_encode(np.concatenate([body, from_int(crc, 16)]))


def csbk_decode(bits196: np.ndarray) -> CSBK | None:
    info, nerr = bptc_196_96_decode(np.asarray(bits196, np.uint8))
    if nerr is None:
        return None
    if not check_crc16_ccitt(info, 80, mask=DMR_MASK_CSBK):
        return None
    csbk = CSBK(
        last_block=bool(info[0]), protected=bool(info[1]),
        opcode=to_int(info, 2, 8), fid=to_int(info, 8, 16),
        data=info[16:80], corrected=nerr)
    csbk.fields = _parse(csbk)
    return csbk


def _parse(c: CSBK) -> dict:
    d = c.data
    if c.fid != 0:
        from .csbk_vendor import parse_vendor_csbk
        fields = parse_vendor_csbk(c.fid, c.opcode, d)
        return fields if fields is not None else {}
    if c.opcode == 0x3D:       # preamble
        return {
            "content": "DATA" if d[0] else "CSBK",
            "target_is_group": bool(d[1]),
            "blocks_to_follow": to_int(d, 8, 16),
            "target_address": to_int(d, 16, 40),
            "source_address": to_int(d, 40, 64),
        }
    if c.opcode == 0x19:       # aloha
        return {
            "service_function": to_int(d, 2, 4),
            "nrand_wait": to_int(d, 8, 12),
            "registration_required": bool(d[13]),
            "backoff": to_int(d, 14, 18),
            "system_identity_code": to_int(d, 18, 32),
            "ms_address": to_int(d, 40, 64),
        }
    if c.opcode in (0x30, 0x31):  # voice channel grants
        return {
            "channel": to_int(d, 0, 12),
            "timeslot": 2 if d[12] else 1,
            "target_address": to_int(d, 16, 40),
            "source_address": to_int(d, 40, 64),
        }
    return {}
