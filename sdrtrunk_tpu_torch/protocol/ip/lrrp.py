"""LRRP (Location Request/Response Protocol) packet + token parsing.

Token ids, lengths, and field scalings mirror the reference's
module/decode/ip/lrrp/token/TokenType.java and the per-token classes
(Point2d.java lat/lon 32-bit scaled by 180/2^32-1 and 360/2^32-1,
Timestamp.java packed calendar fields, Speed.java hundredths m/s,
Heading.java 2-degree units).  The packet wrapper follows
lrrp/LRRPHeader.java (type octet + payload-length octet) and
LRRPPacketType.java.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

__all__ = ["LRRPPacketType", "LRRPToken", "LRRPPacket", "TOKEN_SPECS",
           "parse_lrrp"]


class LRRPPacketType(enum.IntEnum):
    IMMEDIATE_LOCATION_REQUEST = 0x05
    IMMEDIATE_LOCATION_RESPONSE = 0x07
    TRIGGERED_LOCATION_START_REQUEST = 0x09
    TRIGGERED_LOCATION_START_RESPONSE = 0x0B
    TRIGGERED_LOCATION = 0x0D
    TRIGGERED_LOCATION_STOP_REQUEST = 0x0F
    TRIGGERED_LOCATION_STOP_RESPONSE = 0x11
    PROTOCOL_VERSION_REQUEST = 0x14
    PROTOCOL_VERSION_RESPONSE = 0x15
    UNKNOWN = -1

    @classmethod
    def of(cls, value: int) -> "LRRPPacketType":
        try:
            return cls(value)
        except ValueError:
            return cls.UNKNOWN


# token id -> (name, payload length in bytes; -1 = variable with a
# following length octet) — TokenType.java's table
TOKEN_SPECS: dict[int, tuple[str, int]] = {
    0x22: ("IDENTITY", -1),
    0x23: ("UNKNOWN_23", 1),
    0x31: ("TRIGGER_PERIODIC", 1),
    0x34: ("TIMESTAMP", 5),
    0x36: ("VERSION", 1),
    0x37: ("RESPONSE", -1),
    0x38: ("SUCCESS", 0),
    0x3A: ("REQUEST_3A", 0),
    0x42: ("TRIGGER_GPIO", 0),
    0x4A: ("TRIGGER_DISTANCE", 1),
    0x50: ("ALTITUDE_ACCURACY", 0),
    0x51: ("CIRCLE_2D", 10),
    0x52: ("TIME", 0),
    0x54: ("ALTITUDE", 0),
    0x55: ("CIRCLE_3D", 15),
    0x56: ("HEADING", 1),
    0x57: ("HORIZONTAL_DIRECTION", 0),
    0x61: ("REQUEST_61", 1),
    0x62: ("REQUEST_62", 0),
    0x64: ("REQUEST_64", 0),
    0x66: ("POINT_2D", 8),
    0x69: ("POINT_3D", 11),
    0x6C: ("SPEED", 2),
    0x73: ("REQUEST_73", 1),
    0x78: ("TRIGGER_ON_MOVE", 1),
}

_LAT_SCALE = 180.0 / 4294967295.0
_LON_SCALE = 360.0 / 4294967295.0


def _u(data: bytes) -> int:
    v = 0
    for b in data:
        v = (v << 8) | b
    return v


@dataclass
class LRRPToken:
    token_id: int
    name: str
    raw: bytes
    fields: dict = field(default_factory=dict)

    def describe(self) -> str:
        inner = " ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"{self.name}[{inner}]" if inner else self.name


def _decode_fields(token_id: int, name: str, raw: bytes) -> dict:
    out: dict = {}
    if name in ("POINT_2D", "POINT_3D", "CIRCLE_2D", "CIRCLE_3D") \
            and len(raw) >= 8:
        lat_raw = _u(raw[0:4])
        sign = -1.0 if lat_raw & 0x80000000 else 1.0
        # hemisphere flag is the MSB; remaining 31 bits scale to 0..90
        out["latitude"] = round((lat_raw & 0x7FFFFFFF) * _LAT_SCALE * sign, 6)
        lon = _u(raw[4:8]) * _LON_SCALE
        out["longitude"] = round(lon - 360.0 if lon > 180.0 else lon, 6)
        if name in ("CIRCLE_2D", "CIRCLE_3D") and len(raw) >= 10:
            out["radius_m"] = _u(raw[8:10]) * 0.01
        if name == "POINT_3D" and len(raw) >= 11:
            out["altitude_m"] = _u(raw[8:10]) * 0.01
    elif name == "TIMESTAMP" and len(raw) == 5:
        bits = _u(raw)          # 14y 4mo 5d 5h 6m 6s packed (Timestamp.java)
        out["year"] = (bits >> 26) & 0x3FFF
        out["month"] = (bits >> 22) & 0xF
        out["day"] = (bits >> 17) & 0x1F
        out["hour"] = (bits >> 12) & 0x1F
        out["minute"] = (bits >> 6) & 0x3F
        out["second"] = bits & 0x3F
    elif name == "SPEED" and len(raw) == 2:
        out["speed_mps"] = _u(raw) * 0.01
    elif name == "HEADING" and len(raw) == 1:
        out["heading_deg"] = raw[0] * 2
    elif name == "VERSION" and len(raw) == 1:
        out["version"] = raw[0]
    elif name == "IDENTITY":
        out["identity"] = _u(raw)
    elif name == "RESPONSE" and raw:
        out["code"] = raw[0]
    elif name.startswith("TRIGGER_") and len(raw) == 1:
        out["value"] = raw[0]
    return out


@dataclass
class LRRPPacket:
    packet_type: LRRPPacketType
    tokens: list[LRRPToken]

    def token(self, name: str) -> LRRPToken | None:
        for t in self.tokens:
            if t.name == name:
                return t
        return None

    def describe(self) -> str:
        return (f"LRRP {self.packet_type.name} "
                + " ".join(t.describe() for t in self.tokens))


def parse_lrrp(data: bytes) -> LRRPPacket | None:
    """Walk the token stream after the 2-byte header (LRRPHeader.java:
    type octet, payload-length octet)."""
    if len(data) < 2:
        return None
    ptype = LRRPPacketType.of(data[0])
    end = min(len(data), 2 + data[1])
    pos = 2
    tokens: list[LRRPToken] = []
    while pos < end:
        tid = data[pos]
        pos += 1
        name, length = TOKEN_SPECS.get(tid, (f"UNKNOWN_{tid:02X}", 0))
        if length == -1:                   # variable: next octet is length
            if pos >= end:
                break
            length = data[pos]
            pos += 1
        raw = bytes(data[pos:pos + length])
        pos += length
        tokens.append(LRRPToken(tid, name, raw,
                                _decode_fields(tid, name, raw)))
    return LRRPPacket(ptype, tokens)
