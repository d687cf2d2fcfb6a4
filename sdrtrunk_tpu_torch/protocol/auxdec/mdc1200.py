"""Motorola MDC-1200 (1200-baud AFSK, NRZ-I line coding).

Chain per module/decode/mdc1200/MDCDecoder.java:54-61: inverted AFSK
slicer -> NRZ decoder (dsp/NRZDecoder.java, inverted mode) -> framer on
the decoded 40-bit sync 0x07092A446F -> 304-bit message.  Field layout
per MDCMessage.java; the reference leaves the convolutional ECC
unimplemented (MDCMessage.isValid -> true) and so do we.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..bits import hex_to_bits, to_int
from ..framer import MessageFramer

__all__ = ["MDC1200_SYNC", "MDCMessageType", "MDCMessage", "MDCFramer",
           "nrz_decode", "nrz_encode"]

MDC1200_SYNC = hex_to_bits("07092A446F")      # post-NRZ sync, 40 bits
MESSAGE_LENGTH = 304                          # MDCDecoder.java:35


def nrz_decode(bits: np.ndarray, previous: int = 0,
               inverted: bool = True) -> tuple[np.ndarray, int]:
    """NRZ decode mirroring dsp/NRZDecoder.java:process exactly —
    including its quirk of feeding `result` (not the raw symbol) back as
    the previous value: result[k] = result[k-1] ^ symbol[k]; the emitted
    bit is ~result in inverted mode.  Returns (decoded, carry)."""
    b = np.asarray(bits, np.uint8)
    # result is a running XOR (prefix parity) seeded with `previous`
    result = np.bitwise_xor.accumulate(b) ^ np.uint8(previous)
    out = (1 - result) if inverted else result
    carry = int(result[-1]) if len(result) else previous
    return out.astype(np.uint8), carry


def nrz_encode(decoded: np.ndarray, previous: int = 0,
               inverted: bool = True) -> np.ndarray:
    """Inverse of nrz_decode (for test vectors / modulators)."""
    d = np.asarray(decoded, np.uint8)
    result = (1 - d) if inverted else d
    prev = np.concatenate([[np.uint8(previous)], result[:-1]])
    return (result ^ prev).astype(np.uint8)


class MDCMessageType(enum.Enum):
    ACKNOWLEDGE = "Acknowledge"
    ANI = "ANI"
    EMERGENCY = "Emergency"
    PAGING = "Paging"
    STATUS = "Status"
    UNKNOWN = "Unk"


@dataclass
class MDCMessage:
    bits: np.ndarray

    @property
    def opcode(self) -> int:
        # OPCODE bits listed LSB-first {47..40} (MDCMessage.java:15)
        return to_int(self.bits[40:48][::-1])

    @property
    def unit_id(self) -> int:
        # IDENTITY digit-swapped BCD field (MDCMessage.java:27)
        digits = [self.bits[63:59:-1], self.bits[59:55:-1],
                  self.bits[71:67:-1], self.bits[67:63:-1]]
        value = 0
        for d in digits:
            value = (value << 4) | to_int(np.asarray(d))
        return value

    @property
    def is_ani(self) -> bool:
        return bool(self.bits[40])

    @property
    def is_emergency(self) -> bool:
        return bool(self.bits[48])

    @property
    def is_bot(self) -> bool:
        return not bool(self.bits[55])

    @property
    def argument(self) -> int:
        return to_int(self.bits, 49, 55)

    @property
    def message_type(self) -> MDCMessageType:
        op = self.opcode
        if op == 0 and self.is_emergency:
            return MDCMessageType.EMERGENCY
        if op in (0, 1):
            return MDCMessageType.ANI
        return MDCMessageType.UNKNOWN

    def __str__(self):
        return (f"MDC1200 {self.message_type.value} UNIT:{self.unit_id:04X}"
                f" OPCODE:{self.opcode}")


class MDCFramer:
    """NRZ-decoded streaming bits -> MDC messages.  Feed RAW sliced
    symbols from the (inverted) AFSK demod; NRZ decoding happens here.

    Because the reference NRZ decoder feeds its *result* back as the
    previous value (a running XOR), any slicer hiccup before the
    preamble flips the parity and complements every bit thereafter.
    We therefore frame both the decoded stream and its complement —
    a complemented stream carries the true message verbatim."""

    def __init__(self):
        self._framer = MessageFramer(MDC1200_SYNC, MESSAGE_LENGTH)
        self._framer_inv = MessageFramer(MDC1200_SYNC, MESSAGE_LENGTH)
        self._carry = 0

    def reset(self):
        self._framer.reset()
        self._framer_inv.reset()
        self._carry = 0

    def process(self, symbols: np.ndarray) -> list[MDCMessage]:
        decoded, self._carry = nrz_decode(symbols, self._carry)
        out = [MDCMessage(m) for m in self._framer.process(decoded)]
        out += [MDCMessage(m)
                for m in self._framer_inv.process(1 - decoded)]
        return out
