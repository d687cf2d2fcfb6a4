"""Source heartbeat / stall watchdog (role of
source/heartbeat/HeartbeatManager.java:24-39 and the SURVEY §5 failure-
detection note "heartbeat per host": the reference's sources emit
heartbeats on their sample-producer threads so downstream modules can
detect a dead tuner).

`HeartbeatMonitor` watches a sample producer (the libusb BulkStreamer
sink, the native ingest ring's writer, or any source feeding `beat`) on
the monotonic clock: `beat(n_samples)` on every delivery, `check()`
returns the current health and fires `on_stall` once when no samples
arrive within the timeout, and `on_recover` when flow resumes. Wire
`on_stall` to an Orchestrator ERROR_STATE event (or a tuner restart)
for the reference's automatic-channel-stop behavior.
"""
from __future__ import annotations

import time
from typing import Callable

__all__ = ["HeartbeatMonitor"]


class HeartbeatMonitor:
    def __init__(self, timeout_seconds: float = 2.0,
                 on_stall: Callable[[float], None] | None = None,
                 on_recover: Callable[[], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_seconds = float(timeout_seconds)
        self.on_stall = on_stall
        self.on_recover = on_recover
        self._clock = clock
        self._last_beat = clock()
        self._stalled = False
        self.samples = 0
        self.beats = 0
        self.stalls = 0

    def beat(self, n_samples: int = 0) -> None:
        """Producer delivery: restarts the watchdog window."""
        self._last_beat = self._clock()
        self.samples += int(n_samples)
        self.beats += 1
        if self._stalled:
            self._stalled = False
            if self.on_recover is not None:
                self.on_recover()

    @property
    def stalled(self) -> bool:
        return self._stalled

    def check(self) -> bool:
        """Poll the watchdog; returns True while healthy. Fires on_stall
        ONCE per stall (with the silent interval in seconds)."""
        silent = self._clock() - self._last_beat
        if silent >= self.timeout_seconds and not self._stalled:
            self._stalled = True
            self.stalls += 1
            if self.on_stall is not None:
                self.on_stall(silent)
        return not self._stalled
