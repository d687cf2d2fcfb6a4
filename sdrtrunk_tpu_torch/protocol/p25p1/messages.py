"""Frame -> typed message dispatch (role of P25MessageFactory /
P25P1MessageFramer.dispatchMessage, P25P1MessageFramer.java:232+).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .duid import DUID
from .framer import P25P1Frame
from .hdu import hdu_decode, tdulc_decode
from .ldu import ldu1_decode, ldu2_decode
from .pdu import PDUSequence, pdu_decode_block, pdu_decode_header
from .tsbk import tsbk_decode

__all__ = ["P25P1Message", "decode_frame"]


@dataclass
class P25P1Message:
    nac: int
    duid: DUID
    start: int
    content: Any          # TSBK | LDU1 | LDU2 | HDU | PDUSequence | None
    valid: bool
    bit_errors: int = 0
    siblings: list = None  # 2nd/3rd TSBK of a multi-block frame


def decode_frame(frame: P25P1Frame) -> P25P1Message:
    content = None
    valid = True
    siblings = None
    if frame.duid == DUID.TSBK:
        blocks = [tsbk_decode(frame.payload[i:i + 196])
                  for i in range(0, len(frame.payload), 196)]
        content = blocks[0]
        siblings = [b for b in blocks[1:] if b is not None] or None
        valid = content is not None
    elif frame.duid == DUID.PDU:
        header = pdu_decode_header(frame.payload[:196])
        if header is None:
            valid = False
        else:
            seq = PDUSequence(header=header)
            for i in range(196, len(frame.payload), 196):
                seq.blocks.append(pdu_decode_block(
                    frame.payload[i:i + 196],
                    header.confirmation_required))
            content = seq
            valid = seq.complete or header.blocks_to_follow > len(seq.blocks)
    elif frame.duid == DUID.LDU1:
        content = ldu1_decode(frame.payload)
        valid = content.link_control is not None
    elif frame.duid == DUID.LDU2:
        content = ldu2_decode(frame.payload)
        valid = content.message_indicator is not None
    elif frame.duid == DUID.HDU:
        content = hdu_decode(frame.payload)
        valid = content is not None
    elif frame.duid == DUID.TDULC:
        content = tdulc_decode(frame.payload)
        valid = content is not None
    elif frame.duid == DUID.TDU:
        content = None  # terminator: no payload semantics
    extra = getattr(content, "corrected", 0) if content is not None else 0
    return P25P1Message(nac=frame.nac, duid=frame.duid, start=frame.start,
                       content=content, valid=valid,
                       bit_errors=frame.bit_errors + extra,
                       siblings=siblings)
