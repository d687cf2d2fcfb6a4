"""P25 Phase 1 (TIA-102) protocol layer: framing, NID, TSBK/LDU/HDU/TDU
messages (role of module/decode/p25/phase1 in the reference, SURVEY.md
section 2.2).

Device code delivers dense dibit arrays per channel; this package frames
them (sync + BCH-protected NID + status-symbol stripping), applies the
per-DUID EDAC chain, and parses messages into dataclasses. It also provides
ENCODERS for every supported data unit — the reference is receive-only, but
closed-loop self-tests need a transmit path.
"""
from .framer import P25P1Framer, P25P1FrameAssembler
from .nid import NID
from .duid import DUID
