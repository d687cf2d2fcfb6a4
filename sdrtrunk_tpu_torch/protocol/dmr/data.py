"""DMR data-header parsing (ETSI TS 102 361-1 §9.2).

Field layouts mirror the reference's header family:
  - DataHeader.java (DPF bits 4-7)
  - PacketSequenceHeader.java (G/I flag 0, A flag 1, SAP 8-11,
    destination 16-39, source 40-63)
  - OctetDataHeader.java (pad octets {3,12-15}, F flag 64,
    blocks-to-follow 65-71, fragment sequence number 76-79)
  - ConfirmedDataHeader.java (resync 72, send sequence 73-75)
  - ResponseDataHeader.java (blocks 65-71, class/type/status 72-79)
  - ShortDataHeader.java / DefinedShortDataHeader.java /
    StatusDataHeader.java (appended blocks {2,3,12-15}, ports 64-69)
  - ProprietaryDataHeader.java + motorola/MNISProprietaryDataHeader.java
    (SAP 0-3, vendor 8-15, application type 32-39, prefix 56-79)

The 96-bit header is BPTC(196,96)-decoded upstream; its last 16 bits are
a CRC-CCITT with the 0xCCCC data-header mask (CRCDMR.correctCCITT80).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..bits import to_int
from ..edac.crc import DMR_MASK_DATA_HEADER, check_crc16_ccitt

__all__ = ["DataPacketFormat", "ServiceAccessPoint", "Vendor",
           "DMRDataHeader", "parse_data_header"]


class DataPacketFormat(enum.IntEnum):
    """type/DataPacketFormat.java"""
    UNIFIED_DATA_TRANSPORT = 0
    RESPONSE_PACKET = 1
    UNCONFIRMED_DATA_PACKET = 2
    CONFIRMED_DATA_PACKET = 3
    DEFINED_SHORT_DATA = 13
    RAW_OR_STATUS_SHORT_DATA = 14
    PROPRIETARY_DATA_PACKET = 15
    UNKNOWN = -1

    @classmethod
    def of(cls, value: int) -> "DataPacketFormat":
        try:
            return cls(value)
        except ValueError:
            return cls.UNKNOWN


class ServiceAccessPoint(enum.IntEnum):
    """type/ServiceAccessPoint.java (ETSI SAP ids)"""
    UNIFIED_DATA_TRANSPORT = 0
    TCP_HEADER_COMPRESSION = 2
    UDP_HEADER_COMPRESSION = 3
    IP_PACKET_DATA = 4
    ARP = 5
    PROPRIETARY_DATA = 9
    SHORT_DATA = 10
    UNKNOWN = -1

    @classmethod
    def of(cls, value: int) -> "ServiceAccessPoint":
        try:
            return cls(value)
        except ValueError:
            return cls.UNKNOWN


class Vendor(enum.IntEnum):
    """type/Vendor.java (subset used by header dispatch)"""
    STANDARD = 0
    MOTOROLA_CONNECT_PLUS = 6
    HYTERA_8 = 8
    MOTOROLA_CAPACITY_PLUS = 16
    HYTERA_68 = 104
    UNKNOWN = -1

    @classmethod
    def of(cls, value: int) -> "Vendor":
        try:
            return cls(value)
        except ValueError:
            return cls.UNKNOWN


@dataclass
class DMRDataHeader:
    """One parsed 96-bit data header of any DPF flavour."""
    dpf: DataPacketFormat
    crc_ok: bool
    sap: ServiceAccessPoint = ServiceAccessPoint.UNKNOWN
    dst_is_talkgroup: bool = False
    response_requested: bool = False
    dst: int = 0
    src: int = 0
    # octet-data (confirmed/unconfirmed) fields
    pad_octets: int = 0
    final_fragment: bool = False
    blocks_to_follow: int = 0
    fragment_seq: int = 0
    confirmed: bool = False
    resync: bool = False
    send_seq: int = 0
    # response fields
    class_type_status: int = 0
    # short-data fields
    appended_blocks: int = 0
    src_port: int = 0
    dst_port: int = 0
    status: int = 0
    defined_format: int = 0
    full_message: bool = False
    bit_padding: int = 0
    # proprietary fields
    vendor: Vendor = Vendor.UNKNOWN
    application_type: int = 0
    packet_number: int = 0
    prefix_bits: np.ndarray | None = None

    @property
    def is_packet_sequence(self) -> bool:
        """Headers that open a multi-block packet sequence."""
        return self.dpf in (DataPacketFormat.CONFIRMED_DATA_PACKET,
                            DataPacketFormat.UNCONFIRMED_DATA_PACKET,
                            DataPacketFormat.DEFINED_SHORT_DATA,
                            DataPacketFormat.RAW_OR_STATUS_SHORT_DATA)


def parse_data_header(bits96: np.ndarray) -> DMRDataHeader:
    b = np.asarray(bits96, np.uint8)
    crc_ok = check_crc16_ccitt(b, 80, DMR_MASK_DATA_HEADER)
    dpf = DataPacketFormat.of(to_int(b, 4, 8))
    hdr = DMRDataHeader(dpf=dpf, crc_ok=crc_ok)

    if dpf == DataPacketFormat.PROPRIETARY_DATA_PACKET:
        hdr.sap = ServiceAccessPoint.of(to_int(b, 0, 4))
        hdr.vendor = Vendor.of(to_int(b, 8, 16))
        hdr.application_type = to_int(b, 32, 40)
        hdr.packet_number = to_int(b, 40, 56)
        # MNIS prefix: 24 bits prepended to the reassembled packet
        hdr.prefix_bits = b[56:80].copy()
        return hdr

    hdr.dst_is_talkgroup = bool(b[0])
    hdr.response_requested = bool(b[1])
    hdr.sap = ServiceAccessPoint.of(to_int(b, 8, 12))
    hdr.dst = to_int(b, 16, 40)
    hdr.src = to_int(b, 40, 64)

    if dpf in (DataPacketFormat.CONFIRMED_DATA_PACKET,
               DataPacketFormat.UNCONFIRMED_DATA_PACKET):
        hdr.confirmed = dpf == DataPacketFormat.CONFIRMED_DATA_PACKET
        hdr.pad_octets = (int(b[3]) << 4) | to_int(b, 12, 16)
        hdr.final_fragment = bool(b[64])
        hdr.blocks_to_follow = to_int(b, 65, 72)
        hdr.fragment_seq = to_int(b, 76, 80)
        if hdr.confirmed:
            hdr.resync = bool(b[72])
            hdr.send_seq = to_int(b, 73, 76)
    elif dpf == DataPacketFormat.RESPONSE_PACKET:
        hdr.blocks_to_follow = to_int(b, 65, 72)
        hdr.class_type_status = to_int(b, 72, 80)
    elif dpf in (DataPacketFormat.DEFINED_SHORT_DATA,
                 DataPacketFormat.RAW_OR_STATUS_SHORT_DATA):
        hdr.appended_blocks = (to_int(b, 2, 4) << 4) | to_int(b, 12, 16)
        hdr.blocks_to_follow = hdr.appended_blocks
        if dpf == DataPacketFormat.DEFINED_SHORT_DATA:
            hdr.defined_format = to_int(b, 64, 70)
            hdr.resync = bool(b[70])
            hdr.full_message = bool(b[71])
            hdr.bit_padding = to_int(b, 72, 80)
        else:
            hdr.src_port = to_int(b, 64, 67)
            hdr.dst_port = to_int(b, 67, 70)
            hdr.status = to_int(b, 70, 80)
    return hdr
