"""P25 Phase 1 batch framer.

Role of P25P1MessageFramer / P25P1DataUnitDetector / P25P1SyncDetector
(module/decode/p25/phase1/P25P1MessageFramer.java:73,175-229;
P25P1DataUnitDetector.java:33,119-176) — redesigned for array processing:
instead of a per-dibit state machine, each call takes a dense dibit block
(as produced by the vmapped device demodulator), correlates the 48-bit sync
pattern at every alignment in one vectorized op, validates the BCH-protected
NID at each hit, and slices out status-stripped payloads. A carry buffer
preserves streaming semantics across block boundaries.

Frame geometry (TIA-102.BAAA): [sync 24 dibits][NID 32 dibits][payload],
with one status dibit after every 35 transmitted payload dibits measured
from frame start — the sync+NID span holds one status at dibit 35, so
payload dibit k sits at transmitted offset 57 + k + (k + 21) // 35.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bits import (bits_to_dibits, dibits_to_bits, from_int,
                    xor_popcount_correlate)
from .duid import DUID, MESSAGE_LENGTHS, SYNC_PATTERNS
from .nid import NID

__all__ = ["P25P1Frame", "P25P1Framer", "P25P1FrameAssembler",
           "payload_dibit_positions", "assemble_tsbk", "assemble_pdu",
           "chunk_bits"]

SYNC_DIBITS = 24
NID_DIBITS = 32
HEADER_DIBITS = 57  # sync + NID + 1 embedded status dibit
MAX_SYNC_BIT_ERRORS = 9
MAX_PDU_BLOCKS = 32  # supported blocks_to_follow (framer carry bound)

# dibit remaps for PLL quadrant slips: received -> corrected
_ROTATION_REMAPS = {
    "normal": np.arange(4),
    "error_90_ccw": np.array([2, 0, 3, 1]),  # undo +90: 1->0? see below
    "error_90_cw": np.array([1, 3, 0, 2]),
    "error_180": np.array([3, 2, 1, 0]),
}


def payload_dibit_positions(count: int) -> np.ndarray:
    """Transmitted dibit offsets (from frame start) of payload dibits
    0..count-1, skipping the interleaved status dibits."""
    k = np.arange(count)
    return HEADER_DIBITS + k + (k + 21) // 35


def chunk_bits(stream: np.ndarray, s: int, remap: np.ndarray,
               n_chunks: int):
    """Extract n_chunks consecutive 196-bit (98-dibit) chunks of
    status-stripped payload from `stream` at frame start `s`, or None if
    the stream ends first."""
    pos = s + payload_dibit_positions(98 * n_chunks)
    if pos[-1] >= len(stream):
        return None
    return dibits_to_bits(remap[stream[pos]])


def assemble_tsbk(stream: np.ndarray, s: int, remap: np.ndarray):
    """TSBK frames carry 1-3 trellis blocks; the last-block flag of each
    decoded block says whether another follows
    (P25P1MessageFramer TSBK assembly)."""
    from .tsbk import tsbk_decode
    for n in range(1, 4):
        bits = chunk_bits(stream, s, remap, n)
        if bits is None:
            return None
        t = tsbk_decode(bits[-196:])
        if t is None or t.last_block or n == 3:
            return bits


def assemble_pdu(stream: np.ndarray, s: int, remap: np.ndarray):
    """PDU frames: 196-bit header names blocks_to_follow more chunks
    (pdu/PDUMessageFactory.java createPacketSequence)."""
    from .pdu import pdu_decode_header
    head = chunk_bits(stream, s, remap, 1)
    if head is None:
        return None
    header = pdu_decode_header(head)
    if header is None:
        return None
    n_blocks = min(header.blocks_to_follow, MAX_PDU_BLOCKS)
    if n_blocks == 0:
        return head
    return chunk_bits(stream, s, remap, 1 + n_blocks)


@dataclass
class P25P1Frame:
    nac: int
    duid: DUID
    payload: np.ndarray          # status-stripped payload bits
    start: int                   # absolute dibit index of sync start
    bit_errors: int = 0          # sync + NID corrected bits
    rotation: str = "normal"     # PLL quadrant slip detected at sync


class P25P1Framer:
    """Streaming batch framer; feed dibit blocks, receive frames."""

    def __init__(self, max_sync_errors: int = MAX_SYNC_BIT_ERRORS):
        self.max_sync_errors = max_sync_errors
        self._carry = np.zeros(0, dtype=np.uint8)
        self._carry_offset = 0  # absolute dibit index of carry[0]
        self._sync_bits = {
            name: from_int(val, 48) for name, val in SYNC_PATTERNS.items()}
        # longest frame: a PDU header + up to MAX_PDU_BLOCKS data blocks
        # (each 98 dibits + statuses); LDU (784+24) is smaller
        self._max_span = HEADER_DIBITS + \
            int(payload_dibit_positions(98 * (1 + MAX_PDU_BLOCKS))[-1]) + 2

    def process(self, dibits: np.ndarray) -> list[P25P1Frame]:
        stream = np.concatenate(
            [self._carry, np.asarray(dibits, np.uint8)])
        base = self._carry_offset
        bits = dibits_to_bits(stream)
        frames: list[P25P1Frame] = []
        consumed = 0  # dibit index up to which the stream is claimed

        # vectorized sync correlation for all rotations at every bit lag
        errs = {name: xor_popcount_correlate(bits, pat)
                for name, pat in self._sync_bits.items()}
        n_lags = len(errs["normal"])
        if n_lags > 0:
            stacked = np.stack([errs[n] for n in errs])  # (4, lags)
            names = list(errs.keys())
            best = stacked.min(axis=0)
            which = stacked.argmin(axis=0)
            # dibit-aligned lags only
            lags = np.nonzero((np.arange(n_lags) % 2 == 0) &
                              (best <= self.max_sync_errors))[0]
            for lag in lags:
                s = int(lag) // 2  # frame start in dibits
                if s < consumed:
                    continue
                if s + HEADER_DIBITS > len(stream):
                    break
                rotation = names[int(which[lag])]
                remap = _ROTATION_REMAPS[rotation]
                frame = self._try_frame(stream, s, remap, rotation,
                                        int(best[lag]), base)
                if frame is not None:
                    frames.append(frame)
                    n_dib = len(frame.payload) // 2
                    span = (int(payload_dibit_positions(n_dib)[-1]) + 1
                            - HEADER_DIBITS) if n_dib else 0
                    consumed = s + HEADER_DIBITS + span
        # retain tail for next block
        keep_from = max(consumed, len(stream) - self._max_span)
        self._carry = stream[keep_from:]
        self._carry_offset = base + keep_from
        return frames

    def _chunk_bits(self, stream, s, remap, n_chunks):
        return chunk_bits(stream, s, remap, n_chunks)

    def _try_frame(self, stream, s, remap, rotation, sync_errors, base):
        nid_dibits = np.concatenate(
            [stream[s + 24: s + 35], stream[s + 36: s + 57]])
        nid_dibits = remap[nid_dibits]
        nid = NID.decode(dibits_to_bits(nid_dibits))
        if nid is None:
            return None
        try:
            duid = DUID(nid.duid)
        except ValueError:
            return None
        if duid not in MESSAGE_LENGTHS:
            return None
        if duid == DUID.TSBK:
            payload = self._assemble_tsbk(stream, s, remap)
        elif duid == DUID.PDU:
            payload = self._assemble_pdu(stream, s, remap)
        else:
            n_payload_dibits = MESSAGE_LENGTHS[duid] // 2
            pos = s + payload_dibit_positions(n_payload_dibits)
            if len(pos) and pos[-1] >= len(stream):
                return None  # incomplete; carry keeps it for next block
            payload = dibits_to_bits(remap[stream[pos]]) if len(pos) \
                else np.zeros(0, np.uint8)
        if payload is None:
            return None
        return P25P1Frame(nac=nid.nac, duid=duid, payload=payload,
                         start=base + s,
                         bit_errors=sync_errors + nid.corrected,
                         rotation=rotation)

    def _assemble_tsbk(self, stream, s, remap):
        return assemble_tsbk(stream, s, remap)

    def _assemble_pdu(self, stream, s, remap):
        return assemble_pdu(stream, s, remap)


class P25P1FrameAssembler:
    """Transmit-side frame builder (the reference has no transmitter; this
    exists for closed-loop tests and signal generation).

    Produces the on-air dibit stream: sync + NID + payload with status
    dibits inserted at every 36th transmitted position.
    """

    def __init__(self, nac: int = 0x293, status_dibit: int = 1):
        self.nac = nac
        self.status_dibit = status_dibit
        sync_bits = from_int(SYNC_PATTERNS["normal"], 48)
        self._sync_dibits = bits_to_dibits(sync_bits)

    def assemble(self, duid: DUID, payload_bits: np.ndarray) -> np.ndarray:
        expected = MESSAGE_LENGTHS[duid]
        payload_bits = np.asarray(payload_bits, np.uint8)
        if duid in (DUID.TSBK, DUID.PDU):
            # multi-block frames: any multiple of 196 bits
            if len(payload_bits) % 196:
                raise ValueError(
                    f"{duid.name} payload must be a multiple of 196 bits")
        elif len(payload_bits) != expected:
            raise ValueError(
                f"{duid.name} payload must be {expected} bits, "
                f"got {len(payload_bits)}")
        nid_bits = NID.encode(self.nac, duid)
        head = np.concatenate(
            [self._sync_dibits, bits_to_dibits(nid_bits)])  # 56 dibits
        payload_dibits = bits_to_dibits(payload_bits)
        pos = payload_dibit_positions(len(payload_dibits))
        total = int(pos[-1]) + 1 if len(pos) else HEADER_DIBITS
        out = np.full(total, self.status_dibit, dtype=np.uint8)
        # head occupies transmitted dibits 0..56 with status at 35
        out[:35] = head[:35]
        out[36:57] = head[35:]
        out[pos] = payload_dibits
        return out
