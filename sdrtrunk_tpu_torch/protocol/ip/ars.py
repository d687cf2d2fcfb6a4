"""ARS (Automatic Registration Service) packet parsing.

Mirrors module/decode/ip/ars/ARSHeader.java (16-bit length, extension /
ack / priority / control flags, 4-bit PDU type) and the registration
subclasses (DeviceRegistration.java etc.), byte-oriented.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

__all__ = ["ARSPDUType", "ARSPacket", "parse_ars"]


class ARSPDUType(enum.IntEnum):
    DEVICE_REGISTRATION = 0x0
    DEVICE_DEREGISTRATION = 0x1
    QUERY = 0x4
    USER_REGISTRATION = 0x5
    USER_DEREGISTRATION = 0x6
    USER_REGISTRATION_ACKNOWLEDGEMENT = 0x7
    REGISTRATION_ACKNOWLEDGEMENT = 0xF
    UNKNOWN = -1

    @classmethod
    def of(cls, value: int) -> "ARSPDUType":
        try:
            return cls(value)
        except ValueError:
            return cls.UNKNOWN


@dataclass
class ARSPacket:
    pdu_type: ARSPDUType
    length: int
    has_extension: bool
    acknowledge: bool
    priority: bool
    control: bool
    strings: list[str] = field(default_factory=list)

    def describe(self) -> str:
        flags = "".join(c for c, on in
                        [("E", self.has_extension), ("A", self.acknowledge),
                         ("P", self.priority), ("C", self.control)] if on)
        body = "/".join(self.strings)
        return f"ARS {self.pdu_type.name}{' ' + flags if flags else ''}" \
               f"{' ' + body if body else ''}"


def parse_ars(data: bytes) -> ARSPacket | None:
    """Header is 3 bytes: u16 length then a flags/type octet
    (ARSHeader.java bits 16-23: ext, ack, priority, control, 4-bit type).
    Registration payloads carry length-prefixed device/user strings."""
    if len(data) < 3:
        return None
    length = (data[0] << 8) | data[1]
    flags = data[2]
    pkt = ARSPacket(
        pdu_type=ARSPDUType.of(flags & 0xF),
        length=length,
        has_extension=bool(flags & 0x80),
        acknowledge=bool(flags & 0x40),
        priority=bool(flags & 0x20),
        control=bool(flags & 0x10),
    )
    pos = 4 if pkt.has_extension else 3       # extension adds one octet
    end = min(len(data), 2 + length)
    while pos < end:                          # length-prefixed strings
        n = data[pos]
        pos += 1
        if n == 0 or pos + n > end:
            break
        pkt.strings.append(bytes(data[pos:pos + n]).decode(
            "ascii", errors="replace"))
        pos += n
    return pkt
