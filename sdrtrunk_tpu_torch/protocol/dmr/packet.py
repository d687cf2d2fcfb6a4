"""DMR packet-sequence assembly: data header + rate-1/2 / 3/4 / 1 data
blocks -> reassembled octet payload -> IP / proprietary / short-data
message.

Mirrors module/decode/dmr/message/data/packet/PacketSequence.java,
PacketSequenceAssembler.java, and PacketSequenceMessageFactory.java:
a header opens a sequence per timeslot, blocks append until
blocks-to-follow are collected, then the payload fragments (plus the
MNIS proprietary 24-bit packet prefix when present) are concatenated
and dispatched by the header's service access point.

Block payload geometry (block/DataBlock1_2Rate.java etc.):
  rate 1/2: 96 bits  (confirmed: 7-bit serial + 9-bit CRC + 80 payload)
  rate 3/4: 144 bits (confirmed: serial + CRC9 + 128 payload)
  rate 1 : 196 bits  (confirmed: serial + CRC9 + 180 payload)
Rate-3/4 uses the DMR TCM dibit deinterleave of
edac/trellis/ViterbiDecoder_3_4_DMR.java:34 before Viterbi decoding.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bits import from_int, pack_bits, to_int
from ..edac.bptc import bptc_196_96_decode, bptc_196_96_encode
from ..edac.crc import crc9_p25, crc16_ccitt, DMR_MASK_DATA_HEADER
from ..edac.trellis import TRELLIS_3_4_DMR
from .data import (DataPacketFormat, DMRDataHeader, ServiceAccessPoint,
                   parse_data_header)

__all__ = ["DataBlock", "PacketSequence", "PacketSequenceAssembler",
           "DMRPacketMessage", "decode_rate34_block", "encode_rate34_block",
           "encode_data_header", "encode_confirmed_block_1_2",
           "encode_unconfirmed_block_1_2"]

# Dibit deinterleave of ViterbiDecoder_3_4_DMR.java:34 expanded to bit
# indexes: interleaved bit x lands at deinterleaved index _DEINT[x].
_DEINT_DIBITS = np.array([
    0, 1, 8, 9, 16, 17, 24, 25, 32, 33, 40, 41, 48, 49, 56, 57, 64, 65,
    72, 73, 80, 81, 88, 89, 96, 97, 2, 3, 10, 11, 18, 19, 26, 27, 34, 35,
    42, 43, 50, 51, 58, 59, 66, 67, 74, 75, 82, 83, 90, 91, 4, 5, 12, 13,
    20, 21, 28, 29, 36, 37, 44, 45, 52, 53, 60, 61, 68, 69, 76, 77, 84,
    85, 92, 93, 6, 7, 14, 15, 22, 23, 30, 31, 38, 39, 46, 47, 54, 55, 62,
    63, 70, 71, 78, 79, 86, 87, 94, 95], dtype=np.int64)
_DEINT = np.empty(196, dtype=np.int64)
_DEINT[0::2] = _DEINT_DIBITS * 2
_DEINT[1::2] = _DEINT_DIBITS * 2 + 1


def decode_rate34_block(bits196: np.ndarray) -> tuple[np.ndarray, int]:
    """Deinterleave + Viterbi-decode one rate-3/4 block -> (144 bits,
    corrected-bit metric)."""
    b = np.asarray(bits196, np.uint8)
    deint = np.zeros(196, np.uint8)
    deint[_DEINT] = b
    return TRELLIS_3_4_DMR.decode(deint)


def encode_rate34_block(bits144: np.ndarray) -> np.ndarray:
    """Transmit-side inverse for closed-loop tests."""
    enc = TRELLIS_3_4_DMR.encode(np.asarray(bits144, np.uint8))
    return enc[_DEINT]


@dataclass
class DataBlock:
    """One decoded data block (any rate)."""
    bits: np.ndarray            # decoded payload bits (96 / 144 / 196)
    rate: str                   # "1/2" | "3/4" | "1"
    errors: int = 0

    @property
    def serial(self) -> int:
        return to_int(self.bits, 0, 7)

    @property
    def crc_ok(self) -> bool:
        """Confirmed-block CRC-9 (CRCDMR.java CRC9 0x259/0x1FF) over the
        serial + confirmed payload."""
        rx = to_int(self.bits, 7, 16)
        calc = crc9_p25(np.concatenate([self.bits[:7], self.bits[16:]]))
        return rx == calc

    def payload(self, confirmed: bool) -> np.ndarray:
        return self.bits[16:] if confirmed else self.bits


def _confirmed_block(payload_bits: np.ndarray, serial: int) -> np.ndarray:
    head = from_int(serial, 7)
    crc = crc9_p25(np.concatenate([head, np.asarray(payload_bits,
                                                    np.uint8)]))
    return np.concatenate([head, from_int(crc, 9),
                           np.asarray(payload_bits, np.uint8)])


def encode_confirmed_block_1_2(payload80: np.ndarray,
                               serial: int) -> np.ndarray:
    """80 payload bits -> BPTC(196,96)-encoded confirmed rate-1/2 block."""
    return bptc_196_96_encode(_confirmed_block(payload80, serial))


def encode_unconfirmed_block_1_2(payload96: np.ndarray) -> np.ndarray:
    return bptc_196_96_encode(np.asarray(payload96, np.uint8))


def encode_data_header(bits80: np.ndarray) -> np.ndarray:
    """Append the masked CRC-CCITT and BPTC-encode a header for tests."""
    b = np.asarray(bits80, np.uint8)
    crc = crc16_ccitt(b, xor_out=0) ^ DMR_MASK_DATA_HEADER
    return bptc_196_96_encode(np.concatenate([b, from_int(crc, 16)]))


@dataclass
class DMRPacketMessage:
    """Completed packet sequence dispatched per SAP
    (PacketSequenceMessageFactory.create)."""
    header: DMRDataHeader
    payload: bytes
    timeslot: int
    kind: str                   # "ip" | "proprietary" | "short_data" | ...
    packet: object | None = None
    block_crc_failures: int = 0

    def describe(self) -> str:
        base = (f"TS{self.timeslot} {self.header.dpf.name} "
                f"{self.header.src}>{self.header.dst} {self.kind}")
        if self.packet is not None and hasattr(self.packet, "describe"):
            return base + " " + self.packet.describe()
        return base


@dataclass
class PacketSequence:
    header: DMRDataHeader | None = None
    proprietary: DMRDataHeader | None = None
    blocks: list[DataBlock] = field(default_factory=list)

    @property
    def blocks_expected(self) -> int:
        if self.header is None:
            return -1
        n = self.header.blocks_to_follow
        # a proprietary header consumes one of the announced blocks
        if self.proprietary is not None:
            n -= 1
        return n

    @property
    def complete(self) -> bool:
        return (self.header is not None
                and len(self.blocks) >= self.blocks_expected >= 0)


class PacketSequenceAssembler:
    """Per-timeslot packet sequence state machine
    (PacketSequenceAssembler.java)."""

    def __init__(self):
        self._sequences: dict[int, PacketSequence] = {}
        self.messages: list[DMRPacketMessage] = []

    def reset(self, timeslot: int) -> None:
        self._sequences.pop(timeslot, None)

    def on_header(self, timeslot: int, header: DMRDataHeader) -> None:
        if not header.crc_ok:
            return
        if header.dpf == DataPacketFormat.PROPRIETARY_DATA_PACKET:
            seq = self._sequences.get(timeslot)
            if seq is not None:
                seq.proprietary = header
                self._maybe_finish(timeslot)
            return
        if header.is_packet_sequence:
            self._sequences[timeslot] = PacketSequence(header=header)
        else:
            # response / UDT headers complete immediately with no payload
            self.messages.append(DMRPacketMessage(
                header, b"", timeslot, header.dpf.name.lower()))

    def on_block(self, timeslot: int, block: DataBlock) -> None:
        seq = self._sequences.get(timeslot)
        if seq is None:
            return
        seq.blocks.append(block)
        self._maybe_finish(timeslot)

    def _maybe_finish(self, timeslot: int) -> None:
        seq = self._sequences.get(timeslot)
        if seq is None or not seq.complete:
            return
        del self._sequences[timeslot]
        header = seq.header
        confirmed = header.confirmed
        frags = []
        if seq.proprietary is not None \
                and seq.proprietary.prefix_bits is not None:
            frags.append(seq.proprietary.prefix_bits)
        crc_failures = 0
        for blk in seq.blocks:
            if confirmed and not blk.crc_ok:
                crc_failures += 1
            frags.append(blk.payload(confirmed))
        bits = (np.concatenate(frags) if frags
                else np.zeros(0, np.uint8))
        payload = pack_bits(bits)
        sap = header.sap
        if seq.proprietary is not None:
            sap = seq.proprietary.sap
        kind, packet = self._dispatch(sap, seq, payload)
        self.messages.append(DMRPacketMessage(
            header, payload, timeslot, kind, packet, crc_failures))

    @staticmethod
    def _dispatch(sap: ServiceAccessPoint, seq: PacketSequence,
                  payload: bytes):
        from ..ip import parse_ipv4, parse_lrrp, parse_ars
        if sap == ServiceAccessPoint.IP_PACKET_DATA:
            return "ip", parse_ipv4(payload)
        if sap == ServiceAccessPoint.PROPRIETARY_DATA:
            # MNIS application types 0x01=ARS, 0x03/0x05=LRRP
            # (MNISProprietaryDataHeader.java + type/ApplicationType.java)
            app = (seq.proprietary.application_type
                   if seq.proprietary is not None else -1)
            if app == 0x01:
                return "proprietary", parse_ars(payload)
            if app in (0x03, 0x05):
                return "proprietary", parse_lrrp(payload)
            return "proprietary", None
        if sap == ServiceAccessPoint.SHORT_DATA:
            return "short_data", None
        return "unknown", None


BLOCK_RATE_FOR_DATA_TYPE = {7: "1/2", 8: "3/4", 10: "1"}


def decode_block(data_type: int, bits196: np.ndarray) -> DataBlock | None:
    """Decode one data-block burst payload by its slot-type data type
    (DMRDataMessageFactory.java:199 dispatch)."""
    rate = BLOCK_RATE_FOR_DATA_TYPE.get(data_type)
    if rate is None:
        return None
    if rate == "1/2":
        info, nerr = bptc_196_96_decode(np.asarray(bits196, np.uint8))
        if nerr is None:
            return None
        return DataBlock(info, rate, nerr)
    if rate == "3/4":
        info, nerr = decode_rate34_block(bits196)
        return DataBlock(info, rate, nerr)
    return DataBlock(np.asarray(bits196, np.uint8).copy(), rate, 0)
