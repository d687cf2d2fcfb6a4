"""Packet-data IP stack: IPV4/UDP/ICMP parsing plus the Motorola
application protocols carried over them (LRRP location reports, ARS
registration).

Mirrors the capability of the reference's module/decode/ip/ tree
(PacketMessageFactory.java, ipv4/IPV4Packet.java, udp/UDPPacket.java,
lrrp/LRRPPacket.java, ars/ARSPacket.java) with a byte-oriented design:
reassembled over-the-air payloads are octet-aligned, so this layer
works on ``bytes`` produced by ``protocol.bits.pack_bits`` instead of
per-bit index tables.
"""
from .packets import (ICMPHeader, IPProtocol, IPV4Header, IPV4Packet,
                      UDPHeader, ipv4_checksum, parse_ipv4)
from .lrrp import (LRRPPacket, LRRPPacketType, LRRPToken, TOKEN_SPECS,
                   parse_lrrp)
from .ars import ARSPacket, ARSPDUType, parse_ars

__all__ = [
    "IPProtocol", "IPV4Header", "IPV4Packet", "UDPHeader", "ICMPHeader",
    "ipv4_checksum", "parse_ipv4",
    "LRRPPacket", "LRRPPacketType", "LRRPToken", "TOKEN_SPECS", "parse_lrrp",
    "ARSPacket", "ARSPDUType", "parse_ars",
]
