"""P25 Phase 1 Packet Data Unit (PDU): header, data blocks, packet assembly.

Mirrors the reference's PDU stack (module/decode/p25/phase1/message/pdu/
PDUMessageFactory.java, PDUHeader.java, block/{Confirmed,Unconfirmed}
DataBlock.java, packet/PacketMessage.java, ambtc/AMBTCHeader.java):

  * every 196-bit chunk is deinterleaved (P25P1Interleave)
  * the HEADER chunk is 1/2-rate trellis decoded to 96 bits with a
    complemented CRC-16-CCITT over the first 80
  * DATA chunks are 1/2-rate (unconfirmed, 96 bits) or 3/4-rate
    (confirmed, 144 bits: SN(7) CRC-9(9) payload(128)) trellis decoded
  * the re-assembled packet payload carries a complemented CRC-32 in its
    final 4 octets (PacketMessage.java:316)

Encoders are provided for closed-loop tests (the reference has none).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bits import from_int, to_int
from ..edac.crc import (check_crc16_ccitt, crc16_ccitt, crc32_p25,
                        crc9_p25)
from ..edac.trellis import (TRELLIS_1_2_P25, TRELLIS_3_4_P25,
                            deinterleave_p25, interleave_p25)

__all__ = ["PDUHeader", "DataBlock", "PDUSequence", "pdu_decode_header",
           "pdu_decode_block", "pdu_encode_header", "pdu_encode_block",
           "assemble_packet", "build_packet_blocks", "pdu_dispatch",
           "FORMATS", "SAP_NAMES"]

# reference/PDUFormat.java
FORMATS = {
    3: "RESPONSE",
    21: "UNCONFIRMED_MBTC",
    22: "PACKET_DATA",
    23: "ALTERNATE_MBTC",
}

# TIA-102.BAAB service access points (reference ServiceAccessPoint)
SAP_NAMES = {
    0: "UNENCRYPTED_USER_DATA",
    1: "ENCRYPTED_USER_DATA",
    2: "CIRCUIT_DATA",
    3: "CIRCUIT_DATA_CONTROL",
    4: "PACKET_DATA",
    5: "ARP",
    6: "SNDCP_PACKET_DATA_CONTROL",
    15: "EXTENDED_ADDRESS",
    29: "REGISTRATION_AUTHORIZATION",
    30: "CHANNEL_REASSIGNMENT",
    31: "SYSTEM_CONFIGURATION",
    32: "MOBILE_REGISTRATION",
    33: "UNENCRYPTED_KEY_MANAGEMENT",
    34: "ENCRYPTED_KEY_MANAGEMENT",
    61: "TRUNKING_CONTROL",
    63: "PROTECTED_TRUNKING_CONTROL",
}


@dataclass
class PDUHeader:
    confirmation_required: bool
    outbound: bool
    format: int
    sap: int
    vendor: int
    llid: int
    full_message_flag: bool
    blocks_to_follow: int
    pad_octets: int
    packet_sequence: int
    fragment_sequence: int
    header_offset: int
    raw: np.ndarray                      # 96 decoded bits
    corrected: int = 0
    # AMBTC header view (ambtc/AMBTCHeader.java: OPCODE[58:64] DATA[64:80])
    ambtc_opcode: int | None = None

    @property
    def format_name(self) -> str:
        return FORMATS.get(self.format, f"FORMAT_{self.format}")

    @property
    def sap_name(self) -> str:
        return SAP_NAMES.get(self.sap, f"SAP_{self.sap}")


@dataclass
class DataBlock:
    payload: np.ndarray                  # decoded payload bits
    valid: bool
    sequence: int | None = None          # confirmed blocks only
    corrected: int = 0


@dataclass
class PDUSequence:
    """A PDU header plus its following data blocks (pdu/PDUSequence.java)."""
    header: PDUHeader
    blocks: list = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return len(self.blocks) >= self.header.blocks_to_follow


def pdu_decode_header(payload196: np.ndarray) -> PDUHeader | None:
    deint = deinterleave_p25(np.asarray(payload196, np.uint8))
    block96, errors = TRELLIS_1_2_P25.decode(deint)
    if not check_crc16_ccitt(block96, 80):
        return None
    h = PDUHeader(
        confirmation_required=bool(block96[1]),
        outbound=bool(block96[2]),
        format=to_int(block96, 3, 8),
        sap=to_int(block96, 10, 16),
        vendor=to_int(block96, 16, 24),
        llid=to_int(block96, 24, 48),
        full_message_flag=bool(block96[48]),
        blocks_to_follow=to_int(block96, 49, 56),
        pad_octets=to_int(block96, 59, 64),
        packet_sequence=to_int(block96, 65, 67),
        fragment_sequence=to_int(block96, 67, 70),
        header_offset=to_int(block96, 74, 80),
        raw=block96,
        corrected=errors,
    )
    if h.format == 23:  # ALTERNATE_MBTC carries a TSBK-style opcode
        h.ambtc_opcode = to_int(block96, 58, 64)
    return h


def pdu_decode_block(payload196: np.ndarray, confirmed: bool) -> DataBlock:
    deint = deinterleave_p25(np.asarray(payload196, np.uint8))
    if not confirmed:
        block96, errors = TRELLIS_1_2_P25.decode(deint)
        return DataBlock(payload=block96, valid=True, corrected=errors)
    block144, errors = TRELLIS_3_4_P25.decode(deint)
    seq = to_int(block144, 0, 7)
    # CRC-9 over SN + payload (block/ConfirmedDataBlock.java checkCRC)
    data = np.concatenate([block144[:7], block144[16:144]])
    rx = to_int(block144, 7, 16)
    ok = (crc9_p25(data) ^ rx) in (0, 0x1FF)
    return DataBlock(payload=block144[16:144], valid=ok, sequence=seq,
                     corrected=errors)


def pdu_encode_header(format: int, sap: int, llid: int,
                      blocks_to_follow: int, confirmation: bool = False,
                      outbound: bool = True, vendor: int = 0,
                      pad_octets: int = 0, ambtc_opcode: int = 0
                      ) -> np.ndarray:
    """-> 196 on-air bits (for tests; the reference has no encoder)."""
    b = np.zeros(80, np.uint8)

    def put(val, lo, hi):
        b[lo:hi] = from_int(int(val), hi - lo)

    b[1] = int(confirmation)
    b[2] = int(outbound)
    put(format, 3, 8)
    put(sap, 10, 16)
    put(vendor, 16, 24)
    put(llid, 24, 48)
    b[48] = 1   # full message
    put(blocks_to_follow, 49, 56)
    put(pad_octets, 59, 64)
    if format == 23:
        put(ambtc_opcode, 58, 64)
    crc = crc16_ccitt(b)
    block96 = np.concatenate([b, from_int(crc, 16)])
    return interleave_p25(TRELLIS_1_2_P25.encode(block96))


def pdu_encode_block(payload: np.ndarray, confirmed: bool,
                     sequence: int = 0) -> np.ndarray:
    payload = np.asarray(payload, np.uint8)
    if not confirmed:
        if len(payload) != 96:
            raise ValueError("unconfirmed block payload must be 96 bits")
        return interleave_p25(TRELLIS_1_2_P25.encode(payload))
    if len(payload) != 128:
        raise ValueError("confirmed block payload must be 128 bits")
    sn = from_int(sequence, 7)
    crc = crc9_p25(np.concatenate([sn, payload]))
    block144 = np.concatenate([sn, from_int(crc, 9), payload])
    return interleave_p25(TRELLIS_3_4_P25.encode(block144))


def assemble_packet(seq: PDUSequence) -> tuple[bytes, bool] | None:
    """Re-assemble the packet octets from a complete PDU sequence and
    check the trailing CRC-32 (packet/PacketMessage.java).

    Returns (payload_octets_without_crc_and_pad, crc_ok) or None if the
    sequence is incomplete or a confirmed block failed its CRC-9.
    """
    if not seq.complete:
        return None
    if any(not b.valid for b in seq.blocks):
        return None
    bits = np.concatenate([b.payload for b in seq.blocks]) \
        if seq.blocks else np.zeros(0, np.uint8)
    if len(bits) < 32:
        return None
    data, crc_bits_rx = bits[:-32], bits[-32:]
    calc = crc32_p25(data)
    rx = to_int(crc_bits_rx, 0, 32)
    crc_ok = (calc ^ rx) in (0, 0xFFFFFFFF)
    n_pad = seq.header.pad_octets
    octets = np.packbits(data)[:len(data) // 8]
    if n_pad:
        octets = octets[:-n_pad] if n_pad < len(octets) else octets[:0]
    return bytes(octets), crc_ok


def pdu_dispatch(header: PDUHeader, payload: bytes):
    """Route an assembled PDU packet payload to the application layer by
    SAP, like the reference's PDUMessageFactory routing packet data into
    module/decode/ip (PacketMessageFactory.java).  SAP 4 (PACKET_DATA)
    carries IPV4; SNDCP control and others return None (typed header
    only)."""
    if header.sap in (0, 4) and len(payload) >= 20 \
            and (payload[0] >> 4) == 4:
        from ..ip import parse_ipv4
        return parse_ipv4(payload)
    if header.sap == 6:                  # SNDCP_PACKET_DATA_CONTROL
        from .sndcp import parse_sndcp
        return parse_sndcp(payload, header.outbound)
    return None


def build_packet_blocks(octets: bytes, confirmed: bool,
                        ) -> tuple[list[np.ndarray], int, int]:
    """Split packet octets (+CRC-32, +pad) into encoded 196-bit blocks.

    Returns (blocks, blocks_to_follow, pad_octets) — the test-side inverse
    of assemble_packet.
    """
    data = np.unpackbits(np.frombuffer(octets, np.uint8))
    block_bits = 128 if confirmed else 96
    # layout: data || zero-pad || CRC-32(data+pad), padded so the CRC
    # lands in the final 4 octets of the last block
    n_blocks = (len(data) + 32 + block_bits - 1) // block_bits
    pad_bits = n_blocks * block_bits - len(data) - 32
    padded = np.concatenate([data, np.zeros(pad_bits, np.uint8)])
    full = np.concatenate([padded, from_int(crc32_p25(padded), 32)])
    blocks = [
        pdu_encode_block(full[i * block_bits:(i + 1) * block_bits],
                         confirmed, sequence=i)
        for i in range(n_blocks)
    ]
    return blocks, n_blocks, pad_bits // 8
