"""FunCube Dongle (Pro / Pro+) HID control plane.

Mirrors source/tuner/fcd/FCDCommand.java (the HID report command set:
APP_SET_FREQUENCY_HZ 0x65, APP_GET_FREQUENCY_HZ 0x66, PLL lock query
0x69, DC/IQ correction 0x6A-0x6D, LNA/mixer gain) and
FCDTunerController.java's set/get flow.  The HID device is injectable:
``hid_write(report: bytes) -> bytes`` returns the device response
report, so the command framing is unit-testable without hardware.

FCD responses echo the command byte followed by a success byte
(1 = ok), then any payload.
"""
from __future__ import annotations

import struct
from typing import Callable

from .usb import UsbError

__all__ = ["FCDCommand", "FCDProPlusController", "RecordingHid"]


class FCDCommand:
    """FCDCommand.java byte values."""
    APP_SET_FREQUENCY_KHZ = 0x64
    APP_SET_FREQUENCY_HZ = 0x65
    APP_GET_FREQUENCY_HZ = 0x66
    APP_GET_IF_RSSI = 0x68
    APP_GET_PLL_LOCKED = 0x69
    APP_SET_DC_CORRECTION = 0x6A
    APP_GET_DC_CORRECTION = 0x6B
    APP_SET_IQ_CORRECTION = 0x6C
    APP_GET_IQ_CORRECTION = 0x6D
    APP_SET_LNA_GAIN = 0x6E
    APP_SET_MIXER_GAIN = 0x72
    APP_SET_IF_GAIN1 = 0x75


class RecordingHid:
    """Test double: records reports, answers from a script keyed by
    command byte (default: echo + success)."""

    def __init__(self, responses: dict | None = None):
        self.reports: list[bytes] = []
        self.responses = dict(responses or {})

    def __call__(self, report: bytes) -> bytes:
        self.reports.append(bytes(report))
        cmd = report[0]
        if cmd in self.responses:
            resp = self.responses[cmd]
            return resp() if callable(resp) else bytes(resp)
        return bytes([cmd, 1]) + b"\x00" * 62


class FCDProPlusController:
    """FCD Pro+ (V2): 192 kHz IQ over the sound-card interface; control
    over HID (proplusV2/FCDProPlusTunerController.java)."""

    MIN_FREQUENCY = 150_000
    MAX_FREQUENCY = 2_050_000_000
    SAMPLE_RATE = 192_000

    def __init__(self, hid_write: Callable[[bytes], bytes]):
        self.hid = hid_write
        self.frequency = 0

    def _command(self, command: int, payload: bytes = b"") -> bytes:
        response = self.hid(bytes([command]) + payload)
        if len(response) < 2 or response[0] != command:
            raise UsbError(f"FCD command 0x{command:02X}: bad echo "
                           f"{response[:2].hex()}")
        if response[1] != 1:
            raise UsbError(f"FCD command 0x{command:02X} failed")
        return response[2:]

    def set_frequency(self, frequency: int) -> None:
        if not self.MIN_FREQUENCY <= frequency <= self.MAX_FREQUENCY:
            raise UsbError(f"frequency {frequency} outside FCD range")
        self._command(FCDCommand.APP_SET_FREQUENCY_HZ,
                      struct.pack("<I", frequency))
        self.frequency = frequency

    def get_frequency(self) -> int:
        payload = self._command(FCDCommand.APP_GET_FREQUENCY_HZ)
        return struct.unpack("<I", payload[:4])[0]

    def is_pll_locked(self) -> bool:
        payload = self._command(FCDCommand.APP_GET_PLL_LOCKED)
        return bool(payload[0])

    def set_lna_gain(self, enabled: bool) -> None:
        """Pro+ LNA gain is on/off (FCDProPlusTunerController)."""
        self._command(FCDCommand.APP_SET_LNA_GAIN,
                      bytes([1 if enabled else 0]))

    def set_mixer_gain(self, enabled: bool) -> None:
        self._command(FCDCommand.APP_SET_MIXER_GAIN,
                      bytes([1 if enabled else 0]))

    def set_if_gain(self, gain_db: int) -> None:
        if not 0 <= gain_db <= 59:
            raise UsbError(f"IF gain {gain_db} out of 0-59 dB")
        self._command(FCDCommand.APP_SET_IF_GAIN1, bytes([gain_db]))

    def set_dc_correction(self, i: int, q: int) -> None:
        """Signed 16-bit I/Q DC offsets (APP_SET_DC_CORRECTION)."""
        self._command(FCDCommand.APP_SET_DC_CORRECTION,
                      struct.pack("<hh", i, q))

    def set_iq_correction(self, phase: int, gain: int) -> None:
        self._command(FCDCommand.APP_SET_IQ_CORRECTION,
                      struct.pack("<hh", phase, gain))
