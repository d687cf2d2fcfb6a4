"""P25 Phase 2 TDMA protocol layer (role of module/decode/p25/phase2).

Physical layer: HDQPSK at 6000 baud, 12000 bps. A superframe is 4320 bits
= 12 timeslot units of 360 bits ([40-bit ISCH][320-bit timeslot]),
transmitted as 3 fragments of 4 units; units C and D of each fragment
carry the 40-bit sync pattern in place of a coded ISCH word
(SuperFrameFragment.java:16-24). Timeslot payloads are scrambled by a
44-bit LFSR keyed by WACN/SYS/NAC.
"""
from .scrambler import ScramblingSequence, lfsr_sequence
from .isch import isch_encode, isch_decode, ISCH
from .framer import P25P2Framer, P25P2FragmentAssembler, SYNC_BITS
from .timeslot import (Timeslot, DataUnitID, timeslot_decode,
                       facch_encode, sacch_encode)
