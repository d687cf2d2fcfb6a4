"""USB control-plane abstraction for hardware tuner controllers.

Plays the role of source/tuner/usb/USBTransferProcessor.java — but as a
transport *interface* plus a transfer-manager state machine, with no
libusb dependency: real deployments bind a ctypes/libusb transport; the
unit tests bind ``RecordingTransport`` and assert the exact control
sequences each controller issues.  This keeps every register
init/tune/gain state machine testable without hardware, which is the
only part of the reference's USB stack that carries protocol logic.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Protocol

__all__ = ["ControlTransfer", "UsbTransport", "RecordingTransport",
           "TransferProcessor", "TransferState", "UsbError"]


class UsbError(RuntimeError):
    pass


@dataclass(frozen=True)
class ControlTransfer:
    """One vendor control transfer (direction, request, value, index,
    payload)."""
    direction: str                  # "out" | "in"
    request: int
    value: int
    index: int
    data: bytes = b""
    length: int = 0                 # for "in": bytes requested

    def describe(self) -> str:
        if self.direction == "out":
            return (f"OUT req=0x{self.request:02X} val=0x{self.value:04X} "
                    f"idx=0x{self.index:04X} data={self.data.hex()}")
        return (f"IN  req=0x{self.request:02X} val=0x{self.value:04X} "
                f"idx=0x{self.index:04X} len={self.length}")


class UsbTransport(Protocol):
    """Minimal control-endpoint surface the controllers program
    against."""

    def control_out(self, request: int, value: int, index: int,
                    data: bytes = b"") -> None: ...

    def control_in(self, request: int, value: int, index: int,
                   length: int) -> bytes: ...


class RecordingTransport:
    """Test transport: records every transfer; scripted responses for
    IN transfers keyed by (request, value, index) with a default."""

    def __init__(self, responses: dict | None = None,
                 default: bytes = b"\x00" * 16):
        self.transfers: list[ControlTransfer] = []
        self.responses = dict(responses or {})
        self.default = default

    def control_out(self, request: int, value: int, index: int,
                    data: bytes = b"") -> None:
        self.transfers.append(
            ControlTransfer("out", request, value, index, bytes(data)))

    def control_in(self, request: int, value: int, index: int,
                   length: int) -> bytes:
        self.transfers.append(
            ControlTransfer("in", request, value, index, b"", length))
        resp = self.responses.get((request, value, index), self.default)
        if callable(resp):
            resp = resp()
        return bytes(resp)[:length].ljust(length, b"\x00")

    def writes(self) -> list[ControlTransfer]:
        return [t for t in self.transfers if t.direction == "out"]


class TransferState(enum.Enum):
    IDLE = "IDLE"
    RUNNING = "RUNNING"
    RESTARTING = "RESTARTING"
    STOPPED = "STOPPED"
    ERROR = "ERROR"


class TransferProcessor:
    """Bulk-transfer manager state machine
    (USBTransferProcessor.java:46): maintains N in-flight transfers,
    counts completions/errors, restarts the stream after a stall
    burst, and enters ERROR after repeated restart failures."""

    def __init__(self, submit: Callable[[], bool], n_transfers: int = 8,
                 max_consecutive_errors: int = 5, max_restarts: int = 3):
        self._submit = submit
        self.n_transfers = n_transfers
        self.max_consecutive_errors = max_consecutive_errors
        self.max_restarts = max_restarts
        self.state = TransferState.IDLE
        self.in_flight = 0
        self.completed = 0
        self.errors = 0
        self._consecutive_errors = 0
        self._restarts = 0

    def start(self) -> None:
        if self.state in (TransferState.RUNNING, TransferState.ERROR):
            return
        self.state = TransferState.RUNNING
        self._fill()

    def _fill(self) -> None:
        while self.in_flight < self.n_transfers:
            if not self._submit():
                self._on_error()
                return
            self.in_flight += 1

    def on_complete(self, ok: bool) -> None:
        """Driver callback per finished transfer."""
        if self.in_flight > 0:
            self.in_flight -= 1
        if ok:
            self.completed += 1
            self._consecutive_errors = 0
        else:
            self.errors += 1
            self._on_error()
        if self.state == TransferState.RUNNING:
            self._fill()

    def _on_error(self) -> None:
        self._consecutive_errors += 1
        if self._consecutive_errors >= self.max_consecutive_errors:
            self._restart()

    def _restart(self) -> None:
        self._restarts += 1
        self._consecutive_errors = 0
        if self._restarts > self.max_restarts:
            self.state = TransferState.ERROR
            return
        self.state = TransferState.RESTARTING
        self.in_flight = 0
        self.state = TransferState.RUNNING
        self._fill()

    def stop(self) -> None:
        self.state = TransferState.STOPPED
        self.in_flight = 0
