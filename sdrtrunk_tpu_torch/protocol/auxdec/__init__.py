"""Auxiliary decoders carried on analog FM voice channels.

The reference runs these alongside a primary decoder, fed from the
demodulated 8 kHz audio (module/decode/DecoderFactory.java:398-425):
Fleetsync II, MDC-1200, LJ-1200 (LoJack) and Tait 1200 — all 1200-baud
audio FSK framed protocols.
"""
from .fleetsync2 import (Fleetsync2Framer, Fleetsync2Message,
                         FleetsyncMessageType, FLEETSYNC2_SYNC,
                         fleetsync_code)
from .mdc1200 import (MDCFramer, MDCMessage, MDCMessageType, MDC1200_SYNC,
                      nrz_decode, nrz_encode)
from .lj1200 import (LJ1200Framer, LJ1200Message, LJ1200_SYNC,
                     LJ1200_TRANSPONDER_SYNC, lj_code)
from .tait1200 import (Tait1200Framer, Tait1200ANIMessage,
                       Tait1200GPSMessage, TAIT_GPS_SYNC, TAIT_SELCAL_SYNC)

__all__ = [
    "Fleetsync2Framer", "Fleetsync2Message", "FleetsyncMessageType",
    "FLEETSYNC2_SYNC", "fleetsync_code",
    "MDCFramer", "MDCMessage", "MDCMessageType", "MDC1200_SYNC",
    "nrz_decode", "nrz_encode",
    "LJ1200Framer", "LJ1200Message", "LJ1200_SYNC",
    "LJ1200_TRANSPONDER_SYNC", "lj_code",
    "Tait1200Framer", "Tait1200ANIMessage", "Tait1200GPSMessage",
    "TAIT_GPS_SYNC", "TAIT_SELCAL_SYNC",
]
