"""Decode events + bounded history (role of
module/decode/event/DecodeEvent.java and DecodeEventHistory.java).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field

from .identifiers import IdentifierCollection

__all__ = ["DecodeEventType", "DecodeEvent", "DecodeEventHistory"]


class DecodeEventType(enum.Enum):
    CALL_GROUP = "GROUP CALL"
    CALL_GROUP_ENCRYPTED = "ENCRYPTED GROUP CALL"
    CALL_UNIT_TO_UNIT = "UNIT TO UNIT CALL"
    CALL_INTERCONNECT = "TELEPHONE INTERCONNECT"
    CALL_ALERT = "CALL ALERT"
    DATA_CALL = "DATA CALL"
    DATA_PACKET = "DATA PACKET"
    GPS = "GPS"
    PAGE = "PAGE"
    ANNOUNCEMENT = "ANNOUNCEMENT"
    AFFILIATE = "AFFILIATE"
    REGISTER = "REGISTER"
    DEREGISTER = "DEREGISTER"
    RESPONSE = "RESPONSE"
    STATION_ID = "STATION ID"
    COMMAND = "COMMAND"
    SDM = "SHORT DATA MESSAGE"
    UNKNOWN = "UNKNOWN"
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


@dataclass
class DecodeEvent:
    event_type: DecodeEventType
    time_start: float                    # seconds (capture-relative)
    duration: float = 0.0
    protocol: str = ""
    channel: str = ""
    frequency_hz: float | None = None
    details: str = ""
    identifiers: IdentifierCollection = field(
        default_factory=IdentifierCollection)
    timeslot: int = 0
    # plottable-event fields (PlottableDecodeEvent.java): set for GPS
    # events; location is (latitude, longitude) degrees
    location: tuple | None = None
    heading: float | None = None
    speed: float | None = None

    @property
    def plottable(self) -> bool:
        return self.location is not None

    def end(self, now: float) -> None:
        self.duration = max(self.duration, now - self.time_start)

    def update(self, now: float, details: str | None = None) -> None:
        self.end(now)
        if details:
            self.details = details


class DecodeEventHistory:
    """Bounded FIFO of decode events (DecodeEventHistory.java, default
    200 entries)."""

    def __init__(self, capacity: int = 200):
        self._events: deque[DecodeEvent] = deque(maxlen=capacity)
        self._listeners: list = []

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def receive(self, event: DecodeEvent) -> None:
        if event not in self._events:
            self._events.append(event)
        for fn in self._listeners:
            fn(event)

    @property
    def events(self) -> list[DecodeEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
