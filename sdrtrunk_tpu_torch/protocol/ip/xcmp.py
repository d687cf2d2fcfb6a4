"""XCMP: Motorola XNL/XCMP control messages riding UDP port 4004
(module/decode/ip/xcmp/XCMPPacket.java, XCMPHeader.java,
XCMPMessageType.java). The reference models a 1-octet message type
followed by an opaque payload; type 2 is the NETWORK_FREQUENCY_FILE the
MOTOTRBO data stack broadcasts."""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["XCMPPacket", "parse_xcmp", "XCMP_MESSAGE_TYPES"]

# XCMPMessageType.java
XCMP_MESSAGE_TYPES = {
    2: "NETWORK_FREQUENCY_FILE",
}


@dataclass(frozen=True)
class XCMPPacket:
    message_type: int
    payload: bytes

    @property
    def message_type_name(self) -> str:
        return XCMP_MESSAGE_TYPES.get(self.message_type,
                                      f"UNKNOWN_{self.message_type:02X}")

    def describe(self) -> str:
        return (f"XCMP {self.message_type_name} "
                f"({len(self.payload)} bytes)")


def parse_xcmp(data: bytes) -> XCMPPacket | None:
    if len(data) < 1:
        return None
    return XCMPPacket(message_type=data[0], payload=bytes(data[1:]))
