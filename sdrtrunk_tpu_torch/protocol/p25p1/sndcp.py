"""P25 SNDCP control messages (TDS context activation/deactivation).

Mirrors module/decode/p25/phase1/message/pdu/packet/sndcp/: the PDU
type nibble dispatch (SNDCPMessage.java:31,87 + reference/PDUType.java
value/direction table) and the bit layouts of ActivateTdsContextRequest
.java:38-49, ActivateTdsContextAccept.java:41-55 and
ActivateTdsContextReject.java:35-36 / DeActivateTdsContextRequest.
SNDCP control rides PDUs with SAP 6 (SNDCP_PACKET_DATA_CONTROL);
pdu_dispatch routes the assembled payload here.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["SNDCPMessage", "parse_sndcp", "PDU_TYPES_OUTBOUND",
           "PDU_TYPES_INBOUND", "NAT_NAMES", "DEACTIVATION_REASONS"]

PDU_TYPES_OUTBOUND = {
    0: "ACTIVATE_TDS_CONTEXT_ACCEPT",
    1: "DEACTIVATE_TDS_CONTEXT_ACCEPT",
    2: "DEACTIVATE_TDS_CONTEXT_REQUEST",
    3: "ACTIVATE_TDS_CONTEXT_REJECT",
    4: "RF_UNCONFIRMED_DATA",
    5: "RF_CONFIRMED_DATA",
}
PDU_TYPES_INBOUND = {
    0: "ACTIVATE_TDS_CONTEXT_REQUEST",
    1: "DEACTIVATE_TDS_CONTEXT_ACCEPT",
    2: "DEACTIVATE_TDS_CONTEXT_REQUEST",
    5: "RF_CONFIRMED_DATA",
}

# reference NetworkAddressType
NAT_NAMES = {0: "IPV4_STATIC", 1: "IPV4_DYNAMIC", 15: "NONE"}

# reference TdsContextDeactivationReason (subset used in accept/request)
DEACTIVATION_REASONS = {
    0: "USER_INITIATED", 1: "NETWORK_INITIATED",
    2: "SERVICE_NOT_AVAILABLE", 3: "SERVICE_NOT_SUPPORTED",
}


@dataclass
class SNDCPMessage:
    pdu_type: int
    type_name: str
    outbound: bool
    fields: dict = field(default_factory=dict)

    def describe(self) -> str:
        extra = " ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"SNDCP {self.type_name} {extra}".strip()


def _u(bits: bytes, lo: int, hi: int) -> int:
    """Integer from big-endian bit positions [lo, hi) of a byte
    payload (reference int[] field arrays are bit indexes)."""
    v = 0
    for i in range(lo, hi):
        v = (v << 1) | ((bits[i // 8] >> (7 - i % 8)) & 1)
    return v


def _ipv4(bits: bytes, lo: int) -> str:
    return ".".join(str(_u(bits, lo + 8 * i, lo + 8 * i + 8))
                    for i in range(4))


def parse_sndcp(payload: bytes, outbound: bool) -> SNDCPMessage | None:
    """Assembled SAP-6 PDU payload -> typed SNDCP control message."""
    if not payload:
        return None
    pdu_type = payload[0] >> 4
    names = PDU_TYPES_OUTBOUND if outbound else PDU_TYPES_INBOUND
    name = names.get(pdu_type, "UNKNOWN")
    msg = SNDCPMessage(pdu_type=pdu_type, type_name=name,
                       outbound=outbound)
    f = msg.fields
    if outbound and pdu_type == 0 and len(payload) >= 13:
        # ActivateTdsContextAccept.java:41-55
        f["nsapi"] = _u(payload, 4, 8)
        f["priority"] = _u(payload, 8, 12)            # PDUPM
        f["ready_timer"] = _u(payload, 12, 16)
        f["standby_timer"] = _u(payload, 16, 20)
        f["nat"] = NAT_NAMES.get(_u(payload, 20, 24),
                                 str(_u(payload, 20, 24)))
        f["ip_address"] = _ipv4(payload, 24)
        f["mtu"] = _u(payload, 72, 76)
    elif not outbound and pdu_type == 0 and len(payload) >= 10:
        # ActivateTdsContextRequest.java:38-49
        f["version"] = _u(payload, 4, 8)
        f["nsapi"] = _u(payload, 8, 12)
        f["nat"] = NAT_NAMES.get(_u(payload, 12, 16),
                                 str(_u(payload, 12, 16)))
        f["ip_address"] = _ipv4(payload, 16)
        f["dsut"] = _u(payload, 48, 52)
        f["tcpss"] = _u(payload, 64, 68)
        f["udpss"] = _u(payload, 68, 72)
    elif pdu_type == 3 and outbound and len(payload) >= 2:
        # ActivateTdsContextReject.java:35-36
        f["nsapi"] = _u(payload, 4, 8)
        f["reject_reason"] = _u(payload, 8, 16)
    elif pdu_type == 2 and len(payload) >= 2:
        # DeActivateTdsContextRequest: nsapi + reason octet
        f["nsapi"] = _u(payload, 4, 8)
        f["reason"] = DEACTIVATION_REASONS.get(
            _u(payload, 8, 16), str(_u(payload, 8, 16)))
    return msg
