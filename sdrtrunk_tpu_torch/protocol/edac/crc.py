"""CRC engines for P25 / DMR / LTR (role of edac/CRC*.java).

Generic MSB-first polynomial CRC over bit arrays, plus the protocol
parameter sets. Conventions follow the public standards (TIA-102.BAAB,
ETSI TS 102 361-1 annex B):

  * P25 TSBK / PDU header: CRC-16-CCITT, poly 0x1021, init 0, transmitted
    complemented (the reference accepts both residuals,
    edac/CRCP25.java correctPDU: error == 0 || error == 0xFFFFFFFF).
  * P25 confirmed data: CRC-9, poly 0x059, complemented.
  * P25 PDU: CRC-32, poly 0x04C11DB7, complemented.
  * DMR: CRC-CCITT (poly 0x1021) / CRC-8 (0x07)-style codes with a
    per-PDU-type XOR mask applied to the transmitted checksum.
  * LTR: 7-bit sum checksum.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "crc_bits", "crc16_ccitt", "crc32_p25", "crc9_p25", "crc8_dmr",
    "check_crc16_ccitt",
    "DMR_MASK_VOICE_LC", "DMR_MASK_TERMINATOR_LC", "DMR_MASK_PI_HEADER",
    "DMR_MASK_DATA_HEADER", "DMR_MASK_CSBK", "DMR_MASK_MBC_HEADER",
    "DMR_CCITT_MASKS",
]


def crc_bits(bits: np.ndarray, poly: int, width: int, init: int = 0,
             xor_out: int = 0) -> int:
    """MSB-first bitwise CRC of a 0/1 array."""
    reg = init
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for b in np.asarray(bits, np.uint8):
        fb = ((reg >> (width - 1)) & 1) ^ int(b)
        reg = (reg << 1) & mask
        if fb:
            reg ^= poly & mask
    return reg ^ xor_out


def crc16_ccitt(bits: np.ndarray, xor_out: int = 0xFFFF) -> int:
    return crc_bits(bits, 0x1021, 16, 0, xor_out)


def crc32_p25(bits: np.ndarray) -> int:
    return crc_bits(bits, 0x04C11DB7, 32, 0, 0xFFFFFFFF)


def crc9_p25(bits: np.ndarray) -> int:
    return crc_bits(bits, 0x059, 9, 0, 0x1FF)


def crc8_dmr(bits: np.ndarray) -> int:
    return crc_bits(bits, 0x07, 8, 0, 0)


def check_crc16_ccitt(bits: np.ndarray, data_len: int,
                      mask: int = 0) -> bool:
    """True if bits[data_len:data_len+16] is a valid (possibly masked /
    complemented) CCITT CRC of bits[:data_len]."""
    bits = np.asarray(bits, np.uint8)
    calc = crc16_ccitt(bits[:data_len], xor_out=0)
    rx = 0
    for b in bits[data_len:data_len + 16]:
        rx = (rx << 1) | int(b)
    residual = calc ^ rx ^ mask
    return residual == 0 or residual == 0xFFFF


# --- DMR CRC masks (ETSI TS 102 361-1 B.3.11) ---
DMR_MASK_PI_HEADER = 0x6969
DMR_MASK_VOICE_LC = 0x969696        # RS(12,9) 24-bit parity mask
DMR_MASK_TERMINATOR_LC = 0x999999   # RS(12,9) 24-bit parity mask
DMR_MASK_CSBK = 0xA5A5
DMR_MASK_MBC_HEADER = 0xAAAA
DMR_MASK_DATA_HEADER = 0xCCCC

DMR_CCITT_MASKS = {
    "PI_HEADER": DMR_MASK_PI_HEADER,
    "CSBK": DMR_MASK_CSBK,
    "MBC_HEADER": DMR_MASK_MBC_HEADER,
    "DATA_HEADER": DMR_MASK_DATA_HEADER,
}
