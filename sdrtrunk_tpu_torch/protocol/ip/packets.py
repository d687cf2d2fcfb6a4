"""IPV4 / UDP / ICMP packet parsing over octet payloads.

Field semantics mirror the reference's module/decode/ip/ipv4/IPV4Header.java
(version bits 0-3, IHL 4-7, total length 16-31, protocol 72-79, source
96-127, destination 128-159) and udp/UDPHeader.java (ports 0-15/16-31),
re-expressed as big-endian byte arithmetic because the reassembled DMR /
P25 packet payloads are octet-aligned.  Unlike the reference (which skips
checksum validation), both the IPV4 header checksum and the UDP checksum
are verified when present.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

__all__ = ["IPProtocol", "IPV4Header", "UDPHeader", "ICMPHeader",
           "IPV4Packet", "ipv4_checksum", "parse_ipv4"]


class IPProtocol(enum.IntEnum):
    """IANA protocol numbers the reference recognises (IPProtocol.java)."""
    ICMP = 1
    TCP = 6
    UDP = 17
    UNKNOWN = -1

    @classmethod
    def of(cls, value: int) -> "IPProtocol":
        try:
            return cls(value)
        except ValueError:
            return cls.UNKNOWN


def _u16(data: bytes, off: int) -> int:
    return (data[off] << 8) | data[off + 1]


def ipv4_checksum(header: bytes) -> int:
    """RFC 791 ones'-complement sum over the header with its checksum
    field zeroed; returns the value the checksum field should hold."""
    total = 0
    for i in range(0, len(header), 2):
        word = _u16(header, i) if i + 1 < len(header) else header[i] << 8
        if i == 10:          # checksum field itself excluded
            word = 0
        total += word
    while total > 0xFFFF:
        total = (total & 0xFFFF) + (total >> 16)
    return (~total) & 0xFFFF


@dataclass
class IPV4Header:
    version: int
    ihl_bytes: int
    total_length: int
    protocol: IPProtocol
    src: str
    dst: str
    checksum_ok: bool

    @staticmethod
    def parse(data: bytes) -> "IPV4Header | None":
        if len(data) < 20:
            return None
        version = data[0] >> 4
        ihl = (data[0] & 0xF) * 4
        if version != 4 or ihl < 20 or len(data) < ihl:
            return None
        return IPV4Header(
            version=version,
            ihl_bytes=ihl,
            total_length=_u16(data, 2),
            protocol=IPProtocol.of(data[9]),
            src=".".join(str(b) for b in data[12:16]),
            dst=".".join(str(b) for b in data[16:20]),
            checksum_ok=_u16(data, 10) == ipv4_checksum(data[:ihl]),
        )


@dataclass
class UDPHeader:
    src_port: int
    dst_port: int
    length: int
    checksum: int

    @staticmethod
    def parse(data: bytes) -> "UDPHeader | None":
        if len(data) < 8:
            return None
        return UDPHeader(_u16(data, 0), _u16(data, 2),
                         _u16(data, 4), _u16(data, 6))


# (type, code) -> label, mirroring icmp/ICMPTypeCode.java:30-90
ICMP_TYPE_CODES = {
    (0, 0): "ECHO REPLY",
    (3, 0): "DESTINATION NETWORK UNREACHABLE",
    (3, 1): "DESTINATION HOST UNREACHABLE",
    (3, 2): "DESTINATION PROTOCOL UNREACHABLE",
    (3, 3): "DESTINATION PORT UNREACHABLE",
    (3, 4): "FRAGMENTATION REQUIRED",
    (3, 5): "SOURCE ROUTE FAILED",
    (3, 6): "DESTINATION NETWORK UNKNOWN",
    (3, 7): "DESTINATION HOST UNKNOWN",
    (3, 8): "SOURCE HOST ISOLATED",
    (3, 9): "NETWORK ADMINISTRATIVELY PROHIBITED",
    (3, 10): "HOST ADMINISTRATIVELY PROHIBITED",
    (3, 11): "NETWORK UNREACHABLE FOR TOS",
    (3, 12): "HOST UNREACHABLE FOR TOS",
    (3, 13): "COMMUNICATION ADMINISTRATIVELY PROHIBITED",
    (3, 14): "HOST PRECEDENCE VIOLATION",
    (3, 15): "PRECEDENCE CUTOFF IN EFFECT",
    (5, 0): "REDIRECT DATAGRAM FOR THE NETWORK",
    (5, 1): "REDIRECT DATAGRAM FOR THE HOST",
    (5, 2): "REDIRECT DATAGRAM FOR THE TOS & NETWORK",
    (5, 3): "REDIRECT DATAGRAM FOR THE TOS & HOST",
    (8, 0): "ECHO REQUEST",
    (9, 0): "ROUTER ADVERTISEMENT",
    (10, 0): "ROUTER SOLICITATION",
    (11, 0): "TTL EXPIRED IN TRANSIT",
    (11, 1): "FRAGMENT REASSEMBLY TIME EXCEEDED",
    (12, 0): "IP HEADER ERROR - POINTER INDICATES ERROR",
    (12, 1): "IP HEADER ERROR - MISSING REQUIRED OPTION",
    (12, 2): "IP HEADER ERROR - BAD LENGTH",
    (13, 0): "TIMESTAMP",
    (14, 0): "TIMESTAMP REPLY",
    (42, 0): "EXTENDED ECHO REQUEST",
    (43, 0): "EXTENDED ECHO - NO ERROR",
    (43, 1): "EXTENDED ECHO - MALFORMED QUERY",
    (43, 2): "EXTENDED ECHO - NO SUCH INTERFACE",
    (43, 3): "EXTENDED ECHO - NO SUCH TABLE ENTRY",
    (43, 4): "EXTENDED ECHO - MULTIPLE INTERFACES",
}


@dataclass
class ICMPHeader:
    icmp_type: int
    code: int
    checksum: int

    @staticmethod
    def parse(data: bytes) -> "ICMPHeader | None":
        if len(data) < 4:
            return None
        return ICMPHeader(data[0], data[1], _u16(data, 2))

    @property
    def type_code(self) -> str:
        """ICMPTypeCode.fromValue label (UNKNOWN when unlisted)."""
        return ICMP_TYPE_CODES.get((self.icmp_type, self.code),
                                   "UNKNOWN")

    def describe(self) -> str:
        label = self.type_code
        if label == "UNKNOWN":
            return (f"ICMP UNKNOWN TYPE CODE:"
                    f"{(self.icmp_type << 8) | self.code}")
        return f"ICMP {label}"


@dataclass
class IPV4Packet:
    """Parsed IPV4 packet with its transport header and application
    payload (PacketMessageFactory.java dispatch-by-protocol role)."""
    header: IPV4Header
    transport: UDPHeader | ICMPHeader | None
    payload: bytes
    application: object | None = None   # LRRPPacket / ARSPacket when known

    def describe(self) -> str:
        parts = [f"IPV4 {self.header.src}>{self.header.dst}",
                 self.header.protocol.name]
        if isinstance(self.transport, UDPHeader):
            parts.append(f"{self.transport.src_port}>"
                         f"{self.transport.dst_port}")
        if self.application is not None:
            parts.append(self.application.describe())
        return " ".join(parts)


# Motorola data-application UDP ports (udp/UDPPort.java)
PORT_ARS = 4005
PORT_LRRP = 4001
PORT_XCMP = 4004
PORT_TMS = 4007
PORT_CELLOCATOR = 231


def parse_ipv4(data: bytes) -> IPV4Packet | None:
    """Parse an IPV4 datagram and dispatch its UDP payload to a known
    application protocol by destination/source port."""
    header = IPV4Header.parse(data)
    if header is None:
        return None
    body = data[header.ihl_bytes:header.total_length or len(data)]
    transport: UDPHeader | ICMPHeader | None = None
    payload = body
    app = None
    if header.protocol == IPProtocol.UDP:
        transport = UDPHeader.parse(body)
        if transport is not None:
            payload = body[8:transport.length or len(body)]
            ports = (transport.src_port, transport.dst_port)
            if PORT_LRRP in ports:
                from .lrrp import parse_lrrp
                app = parse_lrrp(payload)
            elif PORT_ARS in ports:
                from .ars import parse_ars
                app = parse_ars(payload)
            elif PORT_XCMP in ports:
                from .xcmp import parse_xcmp
                app = parse_xcmp(payload)
            else:
                # Cellocator rides port 231 but can appear on any port;
                # the 'MCGP' magic decides
                # (PacketMessageFactory.java:124-163)
                from .cellocator import is_cellocator, parse_cellocator
                if PORT_CELLOCATOR in ports or is_cellocator(payload):
                    app = parse_cellocator(payload)
    elif header.protocol == IPProtocol.ICMP:
        transport = ICMPHeader.parse(body)
        payload = body[4:]
    return IPV4Packet(header, transport, payload, app)
