"""AMBTC (Alternate Multi-Block Trunking Control) message parsing.

An AMBTC is a PDU sequence (format 23) whose header carries a TSBK-style
opcode plus a 24-bit address, with the structure-specific fields spread
across the header and the unconfirmed data blocks (reference
module/decode/p25/phase1/message/pdu/ambtc/AMBTCMessage.java:38 and the
35 per-opcode classes under ambtc/isp + ambtc/osp; opcode values from
message/tsbk/Opcode.java:30-142). Control channels use AMBTC when a
grant or broadcast needs more payload than one TSBK carries — a trunking
follower that ignores them misses those grants, so the decoder state
routes parsed AMBTC grants into the same TrafficChannelManager path as
TSBK grants (PDUMessageFactory.createAMBTC:208).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..bits import to_int
from .pdu import PDUSequence

__all__ = ["AMBTC", "parse_ambtc", "parse_umbtc",
           "AMBTC_OSP_NAMES", "AMBTC_ISP_NAMES"]

# TSBK opcode space (message/tsbk/Opcode.java) — the subset that appears
# as AMBTC per PDUMessageFactory.createAMBTC
AMBTC_OSP_NAMES = {
    0: "GRP_VCH_GRANT",
    4: "UU_VCH_GRANT",
    5: "UU_ANS_REQ",
    8: "TEL_INT_VCH_GRANT",
    16: "IND_DCH_GRANT",
    17: "GRP_DCH_GRANT",
    24: "STATUS_UPDATE",
    28: "MESSAGE_UPDATE",
    31: "CALL_ALERT",
    58: "RFSS_STATUS_BCST",
    59: "NET_STATUS_BCAST",
    60: "ADJ_STATUS_BCST",
}
AMBTC_ISP_NAMES = {
    4: "UU_V_REQ",
    8: "TELE_INT_DIAL_REQ",
    24: "STS_UPDT_REQ",
    28: "MSG_UPDT_REQ",
    31: "CALL_ALRT_REQ",
    40: "GRP_AFF_REQ",
    45: "LOC_REG_REQ",
}


@dataclass
class AMBTC:
    opcode: int
    outbound: bool                 # OSP (control->subscriber) vs ISP
    address: int                   # 24-bit header address field
    fields: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        table = AMBTC_OSP_NAMES if self.outbound else AMBTC_ISP_NAMES
        return table.get(self.opcode,
                         f"{'OSP' if self.outbound else 'ISP'}"
                         f"_{self.opcode:02X}")


def parse_umbtc(seq: PDUSequence) -> AMBTC | None:
    """UMBTC (format 21): the opcode rides in data block 0 bits [2:8)
    (PDUMessageFactory.createUMBTC:294-311; the reference's only typed
    UMBTC is the telephone-interconnect explicit dial request,
    umbtc/isp/UMBTCTelephoneInterconnectRequestExplicitDialing.java)."""
    h = seq.header
    blocks = [b for b in seq.blocks if b.valid]
    if not blocks:
        return None
    b0 = blocks[0].payload
    msg = AMBTC(opcode=to_int(b0, 2, 8), outbound=h.outbound,
                address=to_int(h.raw, 24, 48))
    if not h.outbound and msg.opcode == 8:   # ISP TEL_INT_DIAL_REQ
        digit_count = to_int(b0, 8, 16)
        msg.fields = {
            "digit_count": digit_count,
            "service_options": to_int(b0, 16, 24),
            "digits": [to_int(b0, 24 + 4 * i, 28 + 4 * i)
                       for i in range(min(digit_count, 18))],
        }
    return msg


def parse_ambtc(seq: PDUSequence) -> AMBTC | None:
    """Parse an AMBTC PDU sequence into typed fields. Returns None when
    the sequence is not AMBTC or lacks its data block."""
    h = seq.header
    if h.ambtc_opcode is None:
        return None
    hb = h.raw                               # 96 decoded header bits
    msg = AMBTC(opcode=h.ambtc_opcode, outbound=h.outbound,
                address=to_int(hb, 24, 48))
    blocks = [b for b in seq.blocks if b.valid]
    if not blocks:
        return msg
    b0 = blocks[0].payload
    f = msg.fields
    op = msg.opcode
    if not h.outbound:
        return msg                           # ISP: header address only
    if op in (0, 17):
        # AMBTCGroupVoiceChannelGrant.java:42-49 /
        # AMBTCGroupDataChannelGrant.java:42-49 (same block layout)
        f["service_options"] = to_int(hb, 64, 72)
        f["frequency_band"] = to_int(b0, 16, 20)
        f["channel_number"] = to_int(b0, 20, 32)
        f["uplink_frequency_band"] = to_int(b0, 32, 36)
        f["uplink_channel_number"] = to_int(b0, 36, 48)
        f["group_address"] = to_int(b0, 48, 64)
        f["source_address"] = msg.address
    elif op == 4:
        # AMBTCUnitToUnitVoiceServiceChannelGrant.java:40-50
        f["service_options"] = to_int(hb, 64, 72)
        f["wacn"] = to_int(b0, 0, 20)
        f["system_id"] = to_int(b0, 20, 32)
        f["source_address"] = to_int(b0, 32, 56)
        f["target_address"] = to_int(b0, 56, 80)
        f["frequency_band"] = to_int(b0, 80, 84)
        f["channel_number"] = to_int(b0, 84, 96)
        if len(blocks) > 1:
            b1 = blocks[1].payload
            f["uplink_frequency_band"] = to_int(b1, 0, 4)
            f["uplink_channel_number"] = to_int(b1, 4, 16)
    elif op == 58:
        # AMBTCRFSSStatusBroadcast.java:49-57
        f["lra"] = to_int(hb, 24, 32)
        f["system_id"] = to_int(hb, 36, 48)
        f["rfss_id"] = to_int(b0, 0, 8)
        f["site_id"] = to_int(b0, 8, 16)
        f["frequency_band"] = to_int(b0, 16, 20)
        f["channel_number"] = to_int(b0, 20, 32)
        f["uplink_frequency_band"] = to_int(b0, 32, 36)
        f["uplink_channel_number"] = to_int(b0, 36, 48)
    elif op == 59:
        # AMBTCNetworkStatusBroadcast.java:50-58
        f["system_id"] = to_int(hb, 36, 48)
        f["wacn"] = to_int(b0, 0, 20)
        f["frequency_band"] = to_int(b0, 24, 28)
        f["channel_number"] = to_int(b0, 28, 40)
        f["uplink_frequency_band"] = to_int(b0, 40, 44)
        f["uplink_channel_number"] = to_int(b0, 44, 56)
        f["system_service_class"] = to_int(b0, 56, 64)
    elif op == 60:
        # AMBTCAdjacentStatusBroadcast.java:42-49
        f["lra"] = to_int(hb, 24, 32)
        f["system_id"] = to_int(hb, 36, 48)
        f["rfss_id"] = to_int(hb, 64, 72)
        f["site_id"] = to_int(hb, 72, 80)
        f["frequency_band"] = to_int(b0, 0, 4)
        f["channel_number"] = to_int(b0, 4, 16)
        f["uplink_frequency_band"] = to_int(b0, 16, 20)
        f["uplink_channel_number"] = to_int(b0, 20, 32)
    return msg
