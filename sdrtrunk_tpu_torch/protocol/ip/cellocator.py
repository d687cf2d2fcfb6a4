"""Cellocator MCGP (fleet-management GPS) packets.

Mirrors module/decode/ip/cellocator/*.java: every message starts with the
4-byte 'MCGP' magic + 1-byte message type (MCGPHeader.java:33-47); the
type value is disambiguated by payload length (MCGPMessageType.java
fromValue — type 0 is an inbound command at 25 bytes but an outbound
location/status report at 70 bytes). Multi-byte fields are
little-endian (the reference's reversed bit arrays,
LocationStatusMessage.java:34-96). Rides UDP port 231 — or any port
carrying the magic (PacketMessageFactory.java:124-163).
"""
from __future__ import annotations

import enum
import math
import struct
from dataclasses import dataclass, field

__all__ = ["MCGPMessageType", "MCGPPacket", "LocationStatus",
           "is_cellocator", "parse_cellocator"]

_MAGIC = b"MCGP"


class MCGPMessageType(enum.Enum):
    """MCGPMessageType.java values; (value, total_bytes) pairs — -1
    length = variable."""
    INBOUND_GENERIC_COMMAND = (0, 25, "COMMAND")
    INBOUND_PROGRAMMING_COMMAND = (1, 34, "PROGRAMMING COMMAND")
    INBOUND_GENERAL_ACKNOWLEDGE = (4, 28, "ACKNOWLEDGE")
    INBOUND_FORWARD_DATA_COMMAND = (5, -1, "FORWARD DATA COMMAND")
    INBOUND_MODULAR_REQUEST = (9, -1, "MODULAR MESSAGE REQUEST")
    OUTBOUND_LOCATION_STATUS = (0, 70, "LOCATION AND STATUS")
    OUTBOUND_PROGRAMMING_STATUS = (3, 31, "CONFIGURATION")
    OUTBOUND_FORWARDED_LOGGED_DATA_FRAGMENT = (7, -1,
                                               "FORWARDED LOGGED DATA")
    OUTBOUND_FORWARDED_REALTIME_DATA = (8, -1,
                                        "FORWARDED SERIAL_PORT DATA")
    OUTBOUND_MODULAR_RESPONSE = (9, -1, "MODULAR MESSAGE RESPONSE")
    OUTBOUND_FIRMWARE_UPDATE = (10, -1, "FIRMWARE UPDATE")
    UNKNOWN = (-1, -1, "UNKNOWN")

    @property
    def label(self) -> str:
        return self.value[2]

    @staticmethod
    def of(type_value: int, total_bytes: int) -> "MCGPMessageType":
        """Type byte + total message length -> message type
        (MCGPMessageType.fromValue)."""
        T = MCGPMessageType
        table = {
            (0, 25): T.INBOUND_GENERIC_COMMAND,
            (0, 70): T.OUTBOUND_LOCATION_STATUS,
            (1, 34): T.INBOUND_PROGRAMMING_COMMAND,
            (3, 31): T.OUTBOUND_PROGRAMMING_STATUS,
            (4, 28): T.INBOUND_GENERAL_ACKNOWLEDGE,
        }
        if (type_value, total_bytes) in table:
            return table[(type_value, total_bytes)]
        variable = {5: T.INBOUND_FORWARD_DATA_COMMAND,
                    7: T.OUTBOUND_FORWARDED_LOGGED_DATA_FRAGMENT,
                    8: T.OUTBOUND_FORWARDED_REALTIME_DATA,
                    9: T.OUTBOUND_MODULAR_RESPONSE,
                    10: T.OUTBOUND_FIRMWARE_UPDATE}
        return variable.get(type_value, T.UNKNOWN)


@dataclass
class LocationStatus:
    """OUTBOUND_LOCATION_STATUS (70 bytes): the GPS fix + unit status
    report (LocationStatusMessage.java field offsets, payload-relative
    little-endian)."""
    unit_id: int
    message_numerator: int
    hardware_version: int
    software_version: int
    transmission_reason: int
    mode_of_operation: int
    io_status: int
    analog_inputs: tuple
    mileage: int
    satellites: int
    latitude: float              # degrees (wire: radians * 1e8, i32)
    longitude: float
    altitude_m: float            # wire: centimeters, i32
    speed_kph: float             # wire: cm/s, i32
    heading_deg: float           # wire: milliradians, u16
    utc: tuple                   # (year, month, day, hour, minute, sec)

    def describe(self) -> str:
        return (f"CELLOCATOR RADIO:{self.unit_id} GPS LOCATION: "
                f"{self.latitude:.5f} {self.longitude:.5f} "
                f"HEADING:{self.heading_deg:.1f} "
                f"SPEED:{self.speed_kph:.1f}kph "
                f"MESSAGE #{self.message_numerator}")


@dataclass
class MCGPPacket:
    message_type: MCGPMessageType
    unit_id: int | None = None
    content: object | None = None
    fields: dict = field(default_factory=dict)

    def describe(self) -> str:
        if self.content is not None:
            return self.content.describe()
        extra = f" RADIO:{self.unit_id}" if self.unit_id is not None \
            else ""
        return f"CELLOCATOR {self.message_type.label}{extra}"


def is_cellocator(data: bytes) -> bool:
    """MCGPHeader.isCellocatorMessage: 'MCGP' magic check."""
    return len(data) >= 5 and data[:4] == _MAGIC


def _i32(p: bytes, off: int) -> int:
    return struct.unpack_from("<i", p, off)[0]


def _u32(p: bytes, off: int) -> int:
    return struct.unpack_from("<I", p, off)[0]


def _u16(p: bytes, off: int) -> int:
    return struct.unpack_from("<H", p, off)[0]


def parse_cellocator(data: bytes) -> MCGPPacket | None:
    """Parse an MCGP datagram (MCGPMessageFactory.create)."""
    if not is_cellocator(data):
        return None
    mtype = MCGPMessageType.of(data[4], len(data))
    p = data[5:]                                  # payload after header
    if mtype == MCGPMessageType.OUTBOUND_LOCATION_STATUS \
            and len(p) >= 64:
        content = LocationStatus(
            unit_id=_u32(p, 0),
            message_numerator=p[6],
            hardware_version=p[7],
            software_version=p[8],
            transmission_reason=p[13],
            mode_of_operation=p[14],
            # io_status / mileage / utc year are read in wire bit order
            # (big-endian) by the reference — only lat/lon/alt/speed/
            # heading get byte-reversed (LocationStatusMessage.java:
            # getInt(UNIT_IO_STATUS/MILEAGE_COUNTER/UTC_TIME_YEAR) with
            # no reversal)
            io_status=struct.unpack_from(">I", p, 15)[0],
            analog_inputs=(p[20], p[21], p[22], p[23]),
            mileage=(p[24] << 16) | (p[25] << 8) | p[26],
            satellites=p[38],
            longitude=math.degrees(_i32(p, 39) / 1e8),
            latitude=math.degrees(_i32(p, 43) / 1e8),
            altitude_m=_i32(p, 47) / 1e2,
            speed_kph=_i32(p, 51) / 1e5 * 3600.0,
            heading_deg=math.degrees(_u16(p, 55) / 1e3),
            utc=((p[62] << 8) | p[63], p[61], p[60], p[59], p[58],
                 p[57]),
        )
        return MCGPPacket(mtype, unit_id=content.unit_id,
                          content=content)
    if mtype in (MCGPMessageType.INBOUND_GENERIC_COMMAND,
                 MCGPMessageType.INBOUND_PROGRAMMING_COMMAND,
                 MCGPMessageType.INBOUND_GENERAL_ACKNOWLEDGE,
                 MCGPMessageType.OUTBOUND_PROGRAMMING_STATUS) \
            and len(p) >= 4:
        # all fixed-size messages lead with the 32-bit LE unit id
        # (AcknowledgeMessage / GenericCommandMessage / Programming*)
        return MCGPPacket(mtype, unit_id=_u32(p, 0))
    return MCGPPacket(mtype)
