"""P25 Phase 1 data unit IDs and frame geometry
(P25P1DataUnitID.java values/lengths; status rules from
P25P1MessageFramer.java:175-190 and TIA-102.BAAA).
"""
from __future__ import annotations

import enum

__all__ = ["DUID", "MESSAGE_LENGTHS", "SYNC_PATTERNS", "STATUS_INTERVAL"]


class DUID(enum.IntEnum):
    HDU = 0
    TDU = 3
    LDU1 = 5
    VSELP1 = 6
    TSBK = 7
    VSELP2 = 9
    LDU2 = 10
    PDU = 12
    TDULC = 15


# payload bits following the NID (status symbols excluded)
MESSAGE_LENGTHS = {
    DUID.HDU: 648 + 10,
    DUID.TDU: 28,
    DUID.LDU1: 1568,
    DUID.TSBK: 196,
    DUID.LDU2: 1568,
    DUID.PDU: 196,
    DUID.TDULC: 308,
}

# 48-bit frame sync and its PLL phase-error images (FrameSync.java:25-35)
SYNC_PATTERNS = {
    "normal": 0x5575F5FF77FF,
    "error_90_ccw": 0xFFEFAFAAEEAA,
    "error_90_cw": 0x001050551155,
    "error_180": 0xAA8A0A008800,
}

# one status dibit after every 35 payload dibits (70 bits), measured from
# frame start (sync dibit 0)
STATUS_INTERVAL = 36
