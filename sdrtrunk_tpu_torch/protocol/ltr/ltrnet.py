"""LTR-Net message typing, parsing, and site tracking.

LTR-Net rides the standard 40-bit LTR word (sync 0-8, area 9, channel
10-14, home 15-19, group 20-27, free 28-32, checksum 33-39) but
overloads out-of-range channel numbers as message-type escapes.  Typing
rules mirror the reference:
  - osw/LtrNetOswMessage.java:46 — channel 17 registration accept,
    18 site id, 24/25 tx/rx frequency (bit 20 picks high/low), 26
    neighbor, 28 channel map (bit 17 picks high/low), 31 call end;
    in-range channel + group 255 idle, otherwise call start.
  - isw/LtrNetIswMessage.java:56 — channel 31 call end, 24 unique id,
    27/29 ESN low/high; in-range channel typed by the FREE field
    (21 call start, 23 call end, 31 request access).  ISW words are
    transmitted bit-inverted (LtrNetMessageFactory.java:61) and accept
    two special checksum escapes (transmitted checksum 127 with free
    31/23).
Frequency math follows osw/Frequency.java:58 (150 MHz + 1250 Hz channel
units split high[4 bits<<12]/low[12 bits]); channel maps follow
ChannelMapLow.java:57.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..bits import to_int
from .messages import SYNC_ISW, SYNC_OSW, WORD_BITS, ltr_checksum

__all__ = ["LtrNetMessageType", "LtrNetMessage", "parse_ltrnet",
           "LtrNetTracker", "ltrnet_encode_word"]


class LtrNetMessageType(enum.Enum):
    OSW_CALL_START = "OSW_CALL_START"
    OSW_CALL_END = "OSW_CALL_END"
    OSW_SYSTEM_IDLE = "OSW_SYSTEM_IDLE"
    OSW_REGISTRATION_ACCEPT = "OSW_REGISTRATION_ACCEPT"
    OSW_SITE_ID = "OSW_SITE_ID"
    OSW_NEIGHBOR_ID = "OSW_NEIGHBOR_ID"
    OSW_TRANSMIT_FREQUENCY_HIGH = "OSW_TRANSMIT_FREQUENCY_HIGH"
    OSW_TRANSMIT_FREQUENCY_LOW = "OSW_TRANSMIT_FREQUENCY_LOW"
    OSW_RECEIVE_FREQUENCY_HIGH = "OSW_RECEIVE_FREQUENCY_HIGH"
    OSW_RECEIVE_FREQUENCY_LOW = "OSW_RECEIVE_FREQUENCY_LOW"
    OSW_CHANNEL_MAP_HIGH = "OSW_CHANNEL_MAP_HIGH"
    OSW_CHANNEL_MAP_LOW = "OSW_CHANNEL_MAP_LOW"
    OSW_UNKNOWN = "OSW_UNKNOWN"
    ISW_CALL_START = "ISW_CALL_START"
    ISW_CALL_END = "ISW_CALL_END"
    ISW_REQUEST_ACCESS = "ISW_REQUEST_ACCESS"
    ISW_UNIQUE_ID = "ISW_UNIQUE_ID"
    ISW_REGISTRATION_REQUEST_ESN_HIGH = "ISW_REGISTRATION_REQUEST_ESN_HIGH"
    ISW_REGISTRATION_REQUEST_ESN_LOW = "ISW_REGISTRATION_REQUEST_ESN_LOW"
    ISW_UNKNOWN = "ISW_UNKNOWN"


@dataclass
class LtrNetMessage:
    message_type: LtrNetMessageType
    direction: str                 # "OSW" | "ISW"
    area: int
    channel: int
    home: int
    group: int
    free: int
    fields: dict = field(default_factory=dict)
    start: int = 0

    def describe(self) -> str:
        inner = " ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"{self.message_type.value}" + (f" {inner}" if inner else "")


def _classify_osw(b: np.ndarray, channel: int, home: int,
                  group: int) -> LtrNetMessageType:
    T = LtrNetMessageType
    # LtrNetOswMessage.java:52 — escape branch needs home != 31 AND
    # (channel > 20 OR home > 20); everything else is call/idle.
    if home != 31 and (channel > 20 or home > 20):
        if channel == 17:
            return T.OSW_REGISTRATION_ACCEPT
        if channel == 18:
            return T.OSW_SITE_ID
        if channel == 24:
            return (T.OSW_TRANSMIT_FREQUENCY_HIGH if b[20]
                    else T.OSW_TRANSMIT_FREQUENCY_LOW)
        if channel == 25:
            return (T.OSW_RECEIVE_FREQUENCY_HIGH if b[20]
                    else T.OSW_RECEIVE_FREQUENCY_LOW)
        if channel == 26:
            return T.OSW_NEIGHBOR_ID
        if channel == 28:
            return (T.OSW_CHANNEL_MAP_HIGH if b[17]
                    else T.OSW_CHANNEL_MAP_LOW)
        if channel == 31:
            return T.OSW_CALL_END
        return T.OSW_UNKNOWN
    return T.OSW_SYSTEM_IDLE if group == 255 else T.OSW_CALL_START


def _classify_isw(b: np.ndarray, channel: int,
                  free: int) -> LtrNetMessageType:
    T = LtrNetMessageType
    if channel == 31:
        return T.ISW_CALL_END
    if channel > 20:
        if channel == 24:
            return T.ISW_UNIQUE_ID
        if channel == 27:
            return T.ISW_REGISTRATION_REQUEST_ESN_LOW
        if channel == 29:
            return T.ISW_REGISTRATION_REQUEST_ESN_HIGH
        return T.ISW_UNKNOWN
    if channel > 0:
        if free == 21:
            return T.ISW_CALL_START
        if free == 23:
            return T.ISW_CALL_END
        if free == 31:
            return T.ISW_REQUEST_ACCESS
    return T.ISW_UNKNOWN


def _extract_fields(mtype: LtrNetMessageType, b: np.ndarray,
                    home: int, group: int) -> dict:
    T = LtrNetMessageType
    f: dict = {}
    if mtype in (T.OSW_CALL_START, T.OSW_CALL_END, T.ISW_CALL_START,
                 T.ISW_CALL_END, T.ISW_REQUEST_ACCESS):
        f["talkgroup"] = (int(b[9]) << 13) | (home << 8) | group
        # channel 31 is the CALL_END escape; the ended call's LCN is the
        # home repeater field
        channel = to_int(b, 10, 15)
        f["lcn"] = home if channel == 31 else channel
    elif mtype in (T.OSW_TRANSMIT_FREQUENCY_HIGH,
                   T.OSW_RECEIVE_FREQUENCY_HIGH):
        f["channel"] = home
        f["units"] = to_int(b, 29, 33) << 12   # FrequencyHigh.java:54
    elif mtype in (T.OSW_TRANSMIT_FREQUENCY_LOW,
                   T.OSW_RECEIVE_FREQUENCY_LOW):
        f["channel"] = home
        f["units"] = to_int(b, 21, 33)         # FrequencyLow.java:51
    elif mtype == T.OSW_SITE_ID:
        f["site"] = to_int(b, 23, 33)          # SiteId.java:64
    elif mtype == T.OSW_NEIGHBOR_ID:
        f["neighbor"] = to_int(b, 23, 33)
        f["rank"] = to_int(b, 15, 19) + 1      # NeighborId.java:73
    elif mtype == T.OSW_CHANNEL_MAP_LOW:
        f["channels"] = [28 - x for x in range(27, 17, -1) if b[x]]
    elif mtype == T.OSW_CHANNEL_MAP_HIGH:
        f["channels"] = [38 - x for x in range(27, 17, -1) if b[x]]
    elif mtype in (T.OSW_REGISTRATION_ACCEPT, T.ISW_UNIQUE_ID):
        f["radio"] = to_int(b, 17, 33)         # SIXTEEN_BITS
    elif mtype in (T.ISW_REGISTRATION_REQUEST_ESN_HIGH,
                   T.ISW_REGISTRATION_REQUEST_ESN_LOW):
        f["esn_part"] = to_int(b, 17, 33)
    return f


def parse_ltrnet(bits40: np.ndarray, direction: str = "OSW",
                 start: int = 0) -> LtrNetMessage | None:
    """Parse one 40-bit word; returns None on checksum failure (except
    the ISW special escapes)."""
    b = np.asarray(bits40, np.uint8)
    if direction == "ISW":
        b = b ^ 1                  # ISW is transmitted inverted
    rx = to_int(b, 33, 40)
    calc = ltr_checksum(b[9:33])
    free = to_int(b, 28, 33)
    if calc != rx:
        # LtrNetIswMessage.java:42 special checksum-127 escapes
        if not (direction == "ISW" and rx == 127 and free in (31, 23)):
            return None
    channel = to_int(b, 10, 15)
    home = to_int(b, 15, 20)
    group = to_int(b, 20, 28)
    if direction == "OSW":
        mtype = _classify_osw(b, channel, home, group)
    else:
        mtype = _classify_isw(b, channel, free)
    return LtrNetMessage(mtype, direction, int(b[9]), channel, home,
                         group, free,
                         _extract_fields(mtype, b, home, group), start)


def ltrnet_encode_word(area: int, channel: int, home: int, group: int,
                       free: int, direction: str = "OSW") -> np.ndarray:
    """Transmit-side word for closed-loop tests (sync + payload +
    checksum, bit-inverted for ISW)."""
    from ..bits import from_int
    payload = np.concatenate([
        from_int(area, 1), from_int(channel, 5), from_int(home, 5),
        from_int(group, 8), from_int(free, 5)])
    word = np.concatenate([SYNC_OSW, payload,
                           from_int(ltr_checksum(payload), 7)])
    if direction == "ISW":
        word = word ^ 1
    return word.astype(np.uint8)


class LtrNetFramer:
    """Streaming word framer for either direction — same vectorized
    sync-correlation walk as LTRFramer, yielding LTR-Net typed
    messages."""

    def __init__(self, direction: str = "OSW"):
        from ..bits import xor_popcount_correlate
        self.direction = direction
        self._sync = SYNC_OSW if direction == "OSW" else SYNC_ISW
        self._correlate = xor_popcount_correlate
        self._carry = np.zeros(0, np.uint8)
        self._offset = 0

    def process(self, bits: np.ndarray) -> list[LtrNetMessage]:
        stream = np.concatenate([self._carry,
                                 np.asarray(bits, np.uint8)])
        base = self._offset
        msgs: list[LtrNetMessage] = []
        errs = self._correlate(stream, self._sync)
        consumed = 0
        for lag in np.nonzero(errs == 0)[0]:
            if lag < consumed or lag + WORD_BITS > len(stream):
                continue
            msg = parse_ltrnet(stream[lag:lag + WORD_BITS],
                               self.direction, base + int(lag))
            if msg is not None:
                msgs.append(msg)
                consumed = int(lag) + WORD_BITS
        keep_from = max(consumed, len(stream) - WORD_BITS + 1)
        self._carry = stream[keep_from:]
        self._offset = base + keep_from
        return msgs


class LtrNetTracker:
    """Site state accumulated from LTR-Net messages — the
    LTRNetDecoderState.java role: channel->frequency tables learned
    from high/low message pairs, channel maps, site/neighbor ids,
    active calls, and registration ESN assembly."""

    def __init__(self):
        self.site_id: int | None = None
        self.neighbors: dict[int, int] = {}      # rank -> site
        self.channels: set[int] = set()
        self.rx_freq: dict[int, int] = {}        # channel -> Hz
        self.tx_freq: dict[int, int] = {}
        self._rx_parts: dict[int, dict[str, int]] = {}
        self._tx_parts: dict[int, dict[str, int]] = {}
        self.active_calls: dict[int, int] = {}   # lcn -> talkgroup
        self.registered_radios: set[int] = set()
        self._esn_high: int | None = None
        self.esns: set[int] = set()
        self.events: list[dict] = []

    def _freq_pair(self, parts: dict[int, dict[str, int]],
                   table: dict[int, int], channel: int, key: str,
                   units: int) -> None:
        slot = parts.setdefault(channel, {})
        slot[key] = units
        if "high" in slot and "low" in slot:
            table[channel] = 150_000_000 + (slot["high"] + slot["low"]) * 1250
            del parts[channel]

    def process(self, msg: LtrNetMessage) -> None:
        T = LtrNetMessageType
        t = msg.message_type
        if t == T.OSW_SITE_ID:
            self.site_id = msg.fields["site"]
        elif t == T.OSW_NEIGHBOR_ID:
            self.neighbors[msg.fields["rank"]] = msg.fields["neighbor"]
        elif t in (T.OSW_CHANNEL_MAP_LOW, T.OSW_CHANNEL_MAP_HIGH):
            self.channels.update(msg.fields["channels"])
        elif t == T.OSW_RECEIVE_FREQUENCY_HIGH:
            self._freq_pair(self._rx_parts, self.rx_freq,
                            msg.fields["channel"], "high",
                            msg.fields["units"])
        elif t == T.OSW_RECEIVE_FREQUENCY_LOW:
            self._freq_pair(self._rx_parts, self.rx_freq,
                            msg.fields["channel"], "low",
                            msg.fields["units"])
        elif t == T.OSW_TRANSMIT_FREQUENCY_HIGH:
            self._freq_pair(self._tx_parts, self.tx_freq,
                            msg.fields["channel"], "high",
                            msg.fields["units"])
        elif t == T.OSW_TRANSMIT_FREQUENCY_LOW:
            self._freq_pair(self._tx_parts, self.tx_freq,
                            msg.fields["channel"], "low",
                            msg.fields["units"])
        elif t == T.OSW_CALL_START:
            lcn = msg.fields["lcn"]
            tg = msg.fields["talkgroup"]
            if self.active_calls.get(lcn) != tg:
                self.active_calls[lcn] = tg
                self.events.append({
                    "type": "CALL_START", "lcn": lcn, "talkgroup": tg,
                    "frequency": self.rx_freq.get(lcn)})
        elif t in (T.OSW_CALL_END, T.ISW_CALL_END):
            lcn = msg.fields.get("lcn", msg.home)
            tg = self.active_calls.pop(lcn, None)
            if tg is not None:
                self.events.append({"type": "CALL_END", "lcn": lcn,
                                    "talkgroup": tg})
        elif t == T.OSW_REGISTRATION_ACCEPT:
            self.registered_radios.add(msg.fields["radio"])
        elif t == T.ISW_REGISTRATION_REQUEST_ESN_HIGH:
            self._esn_high = msg.fields["esn_part"]
        elif t == T.ISW_REGISTRATION_REQUEST_ESN_LOW:
            if self._esn_high is not None:
                self.esns.add((self._esn_high << 16)
                              | msg.fields["esn_part"])
                self._esn_high = None
