"""LTR Standard + LTR-Net trunking protocols (roles of
module/decode/ltrstandard and module/decode/ltrnet).

Word format (40 bits, ltrstandard/message/LTRMessage.java): SYNC(9)
AREA(1) CHANNEL(5) HOME(5) GROUP(8) FREE(5) CHECKSUM(7). ISW words are the
bit-inverse of OSW. Checksum is the 7-bit linear code with the standard
per-bit column table (edac/CRCLTR.java).
"""
from .messages import (LTRMessage, LTRMessageType, LTRFramer, ltr_checksum,
                       ltr_encode_word, SYNC_OSW, SYNC_ISW)
from .ltrnet import (LtrNetFramer, LtrNetMessage, LtrNetMessageType,
                     LtrNetTracker, ltrnet_encode_word, parse_ltrnet)
