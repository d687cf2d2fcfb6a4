"""DMR batch burst framer + transmit-side assembler.

Role of DMRBurstFramer/DMRMessageFramer (module/decode/dmr/DMRBurstFramer.java:61)
redesigned for dense dibit arrays: correlate all sync patterns at every bit
alignment in one pass, frame 288-bit bursts around each hit, and walk voice
superframes (frames B-F carry no sync — they follow frame A at fixed
288-bit strides, validated by their EMB). A carry buffer preserves
streaming across block boundaries.

Burst layout: see burst.py. Data-type dispatch covers CSBK, voice header /
terminator full LC, idle, and voice bursts with AMBE frames + embedded LC.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ..bits import (bits_to_dibits, dibits_to_bits, from_int,
                    xor_popcount_correlate)
from .burst import BURST_BITS, CACH, EMB, SlotType
from .csbk import csbk_decode
from .lc import (MASK_TERMINATOR, MASK_VOICE_HEADER, embedded_lc_decode,
                 full_lc_decode)
from .sync import (CACH_PATTERNS, DATA_PATTERNS, DMRSyncPattern, SYNC_VALUES,
                   VOICE_PATTERNS)

__all__ = ["DMRBurstFrame", "DMRFramer", "DMRBurstAssembler", "DataType"]

SYNC_OFFSET = 132           # bit offset of sync within the 288-bit burst
MAX_SYNC_BIT_ERRORS = 4
BURSTS_PER_SUPERFRAME = 6

VOICE_FRAME_ORDER = [
    DMRSyncPattern.VOICE_FRAME_B, DMRSyncPattern.VOICE_FRAME_C,
    DMRSyncPattern.VOICE_FRAME_D, DMRSyncPattern.VOICE_FRAME_E,
    DMRSyncPattern.VOICE_FRAME_F,
]


class DataType:
    """ETSI data type values (reference type/DataType.java)."""
    PI_HEADER = 0
    VOICE_HEADER = 1
    TLC = 2
    CSBK = 3
    MBC_HEADER = 4
    MBC_BLOCK = 5
    DATA_HEADER = 6
    RATE_1_2_DATA = 7
    RATE_3_4_DATA = 8
    IDLE = 9
    RATE_1_DATA = 10
    USB_DATA = 11


@dataclass(slots=True)
class DMRBurstFrame:
    pattern: DMRSyncPattern
    start: int                    # absolute dibit index of burst start
    bits: np.ndarray              # 288 bits (CACH region zeroed if absent)
    cach: CACH | None = None
    slot_type: SlotType | None = None
    emb: EMB | None = None
    timeslot: int = 1
    content: Any = None           # CSBK | FullLC | voice dict | None
    content_kind: str = ""        # "csbk"|"voice_header"|"terminator"|
    #                               "voice"|"idle"|"data"|""
    sync_errors: int = 0

    @property
    def is_voice(self) -> bool:
        return (self.pattern in VOICE_PATTERNS
                or self.pattern in set(VOICE_FRAME_ORDER))

    def voice_frames(self) -> np.ndarray:
        """Three 72-bit AMBE frames (frame 2 straddles the sync/EMB)."""
        b = self.bits
        return np.stack([
            b[24:96],
            np.concatenate([b[96:132], b[180:216]]),
            b[216:288],
        ])

    def embedded_lc_fragment(self) -> np.ndarray:
        return self.bits[140:172]


class DMRFramer:
    """Streaming batch framer for one channel (both timeslots)."""

    def __init__(self, max_sync_errors: int = MAX_SYNC_BIT_ERRORS):
        self.max_sync_errors = max_sync_errors
        self._carry = np.zeros(0, dtype=np.uint8)
        self._carry_offset = 0
        self._patterns = {p: from_int(v, 48) for p, v in SYNC_VALUES.items()}
        # max lookahead: one burst + 5 voice continuation bursts
        self._max_span_dibits = (BURST_BITS // 2) * 7
        # absolute dibit position of the last emitted burst: the carry
        # always retains the full lookahead window (voice frames B..F
        # carry EMB instead of sync and are only found by the stride walk
        # from frame A's sync, so frame A must stay in the buffer until
        # its superframe completes even across chunked process() calls);
        # re-found bursts are deduplicated against this watermark
        self._emitted_until = -1

    def process(self, dibits: np.ndarray) -> list[DMRBurstFrame]:
        stream = np.concatenate([self._carry,
                                 np.asarray(dibits, np.uint8)])
        base = self._carry_offset
        bits = dibits_to_bits(stream)
        frames: list[DMRBurstFrame] = []

        hits = []  # (bit_pos_of_sync, pattern, errors)
        for pattern, pat_bits in self._patterns.items():
            errs = xor_popcount_correlate(bits, pat_bits)
            for lag in np.nonzero(errs <= self.max_sync_errors)[0]:
                if lag % 2 == 0:
                    hits.append((int(lag), pattern, int(errs[lag])))
        hits.sort()

        claimed = -1
        pending_voice: list[tuple[int, DMRSyncPattern, int]] = []
        for sync_pos, pattern, err in hits:
            burst_start = sync_pos - SYNC_OFFSET
            if burst_start < 0 or burst_start <= claimed:
                continue
            if burst_start + BURST_BITS > len(bits):
                break
            frame = self._frame_burst(bits, burst_start, pattern, err, base)
            frames.append(frame)
            claimed = burst_start
            if pattern in VOICE_PATTERNS:
                # superframe: frames B..F at fixed strides
                for i, vf in enumerate(VOICE_FRAME_ORDER):
                    vstart = burst_start + (i + 1) * BURST_BITS
                    if vstart + BURST_BITS > len(bits):
                        break
                    vframe = self._frame_burst(bits, vstart, vf, 0, base)
                    if vframe.emb is not None and not vframe.emb.valid:
                        break
                    frames.append(vframe)
                    claimed = vstart

        frames.sort(key=lambda f: f.start)
        # dedupe overlapping (voice continuation vs explicit sync) and
        # bursts already emitted by a previous chunked call
        unique: list[DMRBurstFrame] = []
        for f in frames:
            if self._emitted_until >= 0 \
                    and f.start < self._emitted_until + BURST_BITS // 2:
                continue
            if unique and f.start < unique[-1].start + BURST_BITS // 2:
                continue
            unique.append(f)
        if unique:
            self._emitted_until = unique[-1].start

        keep_from = max(0, len(stream) - self._max_span_dibits)
        self._carry = stream[keep_from:]
        self._carry_offset = base + keep_from
        return unique

    def _frame_burst(self, bits, start, pattern, sync_errors, base
                     ) -> DMRBurstFrame:
        burst = bits[start: start + BURST_BITS].copy()
        frame = DMRBurstFrame(pattern=pattern, start=base + start // 2,
                              bits=burst, sync_errors=sync_errors)
        if pattern in CACH_PATTERNS:
            frame.cach = CACH.decode(burst[:24])
            if frame.cach.valid:
                frame.timeslot = frame.cach.timeslot
        if pattern in DATA_PATTERNS:
            frame.slot_type = SlotType.decode(
                np.concatenate([burst[122:132], burst[180:190]]))
            self._decode_data(frame)
        elif frame.is_voice:
            if pattern not in VOICE_PATTERNS:  # frames B..F carry EMB
                frame.emb = EMB.decode(
                    np.concatenate([burst[132:140], burst[172:180]]))
            frame.content_kind = "voice"
            frame.content = {"ambe_frames": frame.voice_frames()}
        return frame

    @staticmethod
    def _decode_data(frame: DMRBurstFrame) -> None:
        if frame.slot_type is None or not frame.slot_type.valid:
            return
        info196 = np.concatenate([frame.bits[24:122], frame.bits[190:288]])
        dt = frame.slot_type.data_type
        if dt == DataType.CSBK:
            frame.content = csbk_decode(info196)
            frame.content_kind = "csbk"
        elif dt in (DataType.VOICE_HEADER, DataType.TLC):
            from ..edac.bptc import bptc_196_96_decode
            info, nerr = bptc_196_96_decode(info196)
            if nerr is not None:
                mask = (MASK_VOICE_HEADER if dt == DataType.VOICE_HEADER
                        else MASK_TERMINATOR)
                frame.content = full_lc_decode(info, mask)
            frame.content_kind = ("voice_header"
                                  if dt == DataType.VOICE_HEADER
                                  else "terminator")
        elif dt == DataType.IDLE:
            frame.content_kind = "idle"
        elif dt == DataType.DATA_HEADER:
            from ..edac.bptc import bptc_196_96_decode
            from .data import parse_data_header
            info, nerr = bptc_196_96_decode(info196)
            if nerr is not None:
                frame.content = parse_data_header(info)
            frame.content_kind = "data_header"
        elif dt in (DataType.RATE_1_2_DATA, DataType.RATE_3_4_DATA,
                    DataType.RATE_1_DATA):
            from .packet import decode_block
            frame.content = decode_block(dt, info196)
            frame.content_kind = "data_block"
        else:
            frame.content_kind = "data"


class DMRBurstAssembler:
    """Transmit-side burst builder (the reference is receive-only; needed
    for closed-loop tests)."""

    def __init__(self, color_code: int = 1):
        self.color_code = color_code

    def _base(self, pattern: DMRSyncPattern, timeslot: int,
              lcss: int = 0) -> np.ndarray:
        bits = np.zeros(BURST_BITS, dtype=np.uint8)
        if pattern in CACH_PATTERNS:
            bits[:24] = CACH.encode(False, timeslot, lcss)
        if pattern.value > 0:
            bits[SYNC_OFFSET:SYNC_OFFSET + 48] = from_int(pattern.value, 48)
        return bits

    def data_burst(self, pattern: DMRSyncPattern, data_type: int,
                   info196: np.ndarray, timeslot: int = 1) -> np.ndarray:
        bits = self._base(pattern, timeslot)
        info196 = np.asarray(info196, np.uint8)
        bits[24:122] = info196[:98]
        bits[190:288] = info196[98:]
        st = SlotType.encode(self.color_code, data_type)
        bits[122:132] = st[:10]
        bits[180:190] = st[10:]
        return bits

    def voice_burst(self, pattern: DMRSyncPattern,
                    ambe_frames: np.ndarray, timeslot: int = 1,
                    emb_lcss: int = 0,
                    lc_fragment: np.ndarray | None = None) -> np.ndarray:
        """pattern: a VOICE sync pattern for frame A, or VOICE_FRAME_B..F."""
        bits = self._base(pattern, timeslot)
        af = np.asarray(ambe_frames, np.uint8).reshape(3, 72)
        bits[24:96] = af[0]
        bits[96:132] = af[1][:36]
        bits[180:216] = af[1][36:]
        bits[216:288] = af[2]
        if pattern not in VOICE_PATTERNS:
            emb = EMB.encode(self.color_code, False, emb_lcss)
            bits[132:140] = emb[:8]
            bits[172:180] = emb[8:]
            if lc_fragment is not None:
                bits[140:172] = np.asarray(lc_fragment, np.uint8)
        return bits

    @staticmethod
    def to_dibits(bursts: list[np.ndarray]) -> np.ndarray:
        return bits_to_dibits(np.concatenate(bursts))
