"""DMR 48-bit sync patterns (ETSI TS 102 361-1 9.1.1; values match the
reference's DMRSyncPattern.java enum)."""
from __future__ import annotations

import enum

__all__ = ["DMRSyncPattern", "SYNC_VALUES", "VOICE_PATTERNS",
           "DATA_PATTERNS", "CACH_PATTERNS"]


class DMRSyncPattern(enum.Enum):
    BASE_STATION_DATA = 0xDFF57D75DF5D
    BASE_STATION_VOICE = 0x755FD7DF75F7
    MOBILE_STATION_DATA = 0xD5D7F77FD757
    MOBILE_STATION_VOICE = 0x7F7D5DD57DFD
    DIRECT_MODE_DATA_TS1 = 0xF7FDD5DDFD55
    DIRECT_MODE_DATA_TS2 = 0xD7557F5FF7F5
    DIRECT_MODE_VOICE_TS1 = 0x5D577F7757FF
    DIRECT_MODE_VOICE_TS2 = 0x7DFFD5F55D5F
    MOBILE_STATION_REVERSE = 0x77D55F7DFD77
    # voice superframe continuation markers (no on-air sync)
    VOICE_FRAME_B = -2
    VOICE_FRAME_C = -3
    VOICE_FRAME_D = -4
    VOICE_FRAME_E = -5
    VOICE_FRAME_F = -6
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


SYNC_VALUES = {p: p.value for p in DMRSyncPattern if p.value > 0}

VOICE_PATTERNS = {
    DMRSyncPattern.BASE_STATION_VOICE,
    DMRSyncPattern.MOBILE_STATION_VOICE,
    DMRSyncPattern.DIRECT_MODE_VOICE_TS1,
    DMRSyncPattern.DIRECT_MODE_VOICE_TS2,
}

DATA_PATTERNS = {
    DMRSyncPattern.BASE_STATION_DATA,
    DMRSyncPattern.MOBILE_STATION_DATA,
    DMRSyncPattern.DIRECT_MODE_DATA_TS1,
    DMRSyncPattern.DIRECT_MODE_DATA_TS2,
}

# patterns whose bursts carry a CACH (base-station continuous mode)
CACH_PATTERNS = {
    DMRSyncPattern.BASE_STATION_DATA,
    DMRSyncPattern.BASE_STATION_VOICE,
    DMRSyncPattern.VOICE_FRAME_B,
    DMRSyncPattern.VOICE_FRAME_C,
    DMRSyncPattern.VOICE_FRAME_D,
    DMRSyncPattern.VOICE_FRAME_E,
    DMRSyncPattern.VOICE_FRAME_F,
}
