"""Decode-event logger sinks: CSV and JSONL files of DecodeEvents
(role of module/log/DecodeEventLogger.java — its
TIMESTAMP,DURATION_MS,PROTOCOL,EVENT,FROM,TO,CHANNEL_NUMBER,FREQUENCY,
TIMESLOT,DETAILS column set, getCSVHeader:92). Timestamps are the
capture-relative sample clock in seconds (the orchestrator's time base),
keeping logs deterministic and replayable."""
from __future__ import annotations

import json

from .events import DecodeEvent
from .identifiers import IdentifierRole

__all__ = ["DecodeEventLogger", "CSV_HEADER"]

CSV_HEADER = ("TIMESTAMP,DURATION_MS,PROTOCOL,EVENT,FROM,TO,"
              "CHANNEL_NUMBER,FREQUENCY,TIMESLOT,DETAILS")


def _role_value(event: DecodeEvent, role: IdentifierRole) -> str:
    for ident in event.identifiers.all():
        if ident.role == role:
            return str(ident.value)
    return ""


def _csv_cell(text: str) -> str:
    if any(c in text for c in ",\"\n"):
        return '"' + text.replace('"', '""') + '"'
    return text


class DecodeEventLogger:
    """Append DecodeEvents to a CSV or JSONL file; format picked from the
    path suffix (.csv / .jsonl). Register `receive` as a
    DecodeEventHistory listener or call it directly."""

    def __init__(self, path, channel: str = ""):
        self.path = str(path)
        self.channel = channel
        self._format = "jsonl" if self.path.endswith(".jsonl") else "csv"
        self._fh = open(self.path, "a")
        if self._format == "csv" and self._fh.tell() == 0:
            self._fh.write(CSV_HEADER + "\n")
        self.count = 0

    def receive(self, event: DecodeEvent) -> None:
        if self._format == "csv":
            cells = [
                f"{event.time_start:.6f}",
                (f"{event.duration * 1000.0:.0f}" if event.duration > 0
                 else ""),
                event.protocol,
                event.event_type.value,
                _role_value(event, IdentifierRole.FROM),
                _role_value(event, IdentifierRole.TO),
                event.channel or self.channel,
                (f"{event.frequency_hz:.0f}"
                 if event.frequency_hz is not None else ""),
                str(event.timeslot),
                _csv_cell(event.details),
            ]
            self._fh.write(",".join(cells) + "\n")
        else:
            self._fh.write(json.dumps({
                "t": round(event.time_start, 6),
                "duration_ms": round(event.duration * 1000.0, 1),
                "protocol": event.protocol,
                "event": event.event_type.value,
                "from": _role_value(event, IdentifierRole.FROM),
                "to": _role_value(event, IdentifierRole.TO),
                "channel": event.channel or self.channel,
                "frequency_hz": event.frequency_hz,
                "timeslot": event.timeslot,
                "details": event.details,
            }) + "\n")
        self._fh.flush()
        self.count += 1

    def close(self) -> None:
        self._fh.close()
