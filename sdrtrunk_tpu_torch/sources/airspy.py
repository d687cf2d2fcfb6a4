"""Airspy board control plane over an injectable USB transport.

Mirrors source/tuner/airspy/AirspyTunerController.java: the vendor
command table (Command enum :1108), the coupled linearity/sensitivity
gain tables (Gain enum :925 — each step programs VGA/IF, mixer, and
LNA together), AGC interlocks, and frequency programming.
"""
from __future__ import annotations

import struct

from .usb import UsbError, UsbTransport

__all__ = ["AirspyController", "LINEARITY_GAINS", "SENSITIVITY_GAINS"]


class Command:
    RECEIVER_MODE = 1
    SET_SAMPLE_RATE = 12
    SET_FREQUENCY = 13
    SET_LNA_GAIN = 14
    SET_MIXER_GAIN = 15
    SET_VGA_GAIN = 16
    SET_LNA_AGC = 17
    SET_MIXER_AGC = 18
    GET_SAMPLE_RATES = 25
    SET_PACKING = 26


MIN_FREQUENCY = 24_000_000
MAX_FREQUENCY = 1_800_000_000
LNA_GAIN_MAX = 14
MIXER_GAIN_MAX = 15
VGA_GAIN_MAX = 15

# step -> (vga/if, mixer, lna) — AirspyTunerController.java:925 Gain enum
LINEARITY_GAINS = {
    1: (4, 0, 0), 2: (5, 0, 0), 3: (6, 1, 0), 4: (7, 1, 0), 5: (8, 1, 0),
    6: (9, 1, 0), 7: (10, 2, 0), 8: (10, 2, 1), 9: (10, 0, 3),
    10: (10, 0, 5), 11: (10, 1, 6), 12: (10, 0, 8), 13: (10, 0, 9),
    14: (10, 5, 8), 15: (10, 6, 9), 16: (11, 6, 9), 17: (11, 7, 10),
    18: (11, 8, 12), 19: (11, 9, 13), 20: (11, 11, 14), 21: (12, 12, 14),
    22: (13, 12, 14),
}
SENSITIVITY_GAINS = {
    1: (4, 0, 0), 2: (4, 0, 1), 3: (4, 0, 2), 4: (4, 0, 3), 5: (4, 1, 5),
    6: (4, 2, 6), 7: (4, 2, 7), 8: (4, 3, 8), 9: (4, 4, 9), 10: (5, 4, 9),
    11: (5, 4, 12), 12: (5, 7, 12), 13: (5, 8, 13), 14: (5, 9, 14),
    15: (6, 9, 14), 16: (7, 10, 14), 17: (8, 10, 14), 18: (9, 11, 14),
    19: (10, 12, 14), 20: (11, 12, 14), 21: (12, 12, 14), 22: (13, 12, 14),
}


class AirspyController:
    def __init__(self, transport: UsbTransport):
        self.t = transport
        self.frequency = 0
        self.sample_rates: list[int] = []

    def _byte_command(self, command: int, value: int, index: int) -> None:
        """Single-status-byte commands (readByte in the reference): the
        device acks with one byte."""
        ack = self.t.control_in(command, value, index, 1)
        if ack and ack[0] != 0 and command not in (Command.SET_FREQUENCY,):
            # Airspy firmware acks 0 for success on gain/AGC commands
            raise UsbError(f"airspy command {command} nacked: {ack[0]}")

    def read_sample_rates(self) -> list[int]:
        """GET_SAMPLE_RATES: first query the count, then the rates
        (AirspyTunerController.getSampleRates)."""
        raw = self.t.control_in(Command.GET_SAMPLE_RATES, 0, 0, 4)
        count = struct.unpack("<I", raw)[0]
        if count == 0 or count > 16:
            raise UsbError(f"implausible airspy rate count {count}")
        raw = self.t.control_in(Command.GET_SAMPLE_RATES, 0, count,
                                4 * count)
        self.sample_rates = list(struct.unpack(f"<{count}I", raw))
        return self.sample_rates

    def set_sample_rate(self, rate: int) -> None:
        if self.sample_rates and rate not in self.sample_rates:
            raise UsbError(f"rate {rate} not offered by board "
                           f"{self.sample_rates}")
        index = (self.sample_rates.index(rate)
                 if self.sample_rates else rate)
        self._byte_command(Command.SET_SAMPLE_RATE, 0, index)

    def set_frequency(self, frequency: int) -> None:
        if not MIN_FREQUENCY <= frequency <= MAX_FREQUENCY:
            raise UsbError(f"frequency {frequency} outside Airspy range")
        self.t.control_out(Command.SET_FREQUENCY, 0, 0,
                           struct.pack("<I", frequency))
        self.frequency = frequency

    def set_lna_gain(self, gain: int) -> None:
        if not 0 <= gain <= LNA_GAIN_MAX:
            raise UsbError(f"LNA gain {gain} out of 0-{LNA_GAIN_MAX}")
        self._byte_command(Command.SET_LNA_GAIN, 0, gain)

    def set_mixer_gain(self, gain: int) -> None:
        if not 0 <= gain <= MIXER_GAIN_MAX:
            raise UsbError(f"mixer gain {gain} out of 0-{MIXER_GAIN_MAX}")
        self._byte_command(Command.SET_MIXER_GAIN, 0, gain)

    def set_vga_gain(self, gain: int) -> None:
        if not 0 <= gain <= VGA_GAIN_MAX:
            raise UsbError(f"VGA gain {gain} out of 0-{VGA_GAIN_MAX}")
        self._byte_command(Command.SET_VGA_GAIN, 0, gain)

    def set_lna_agc(self, enabled: bool) -> None:
        self._byte_command(Command.SET_LNA_AGC, 0, 1 if enabled else 0)

    def set_mixer_agc(self, enabled: bool) -> None:
        self._byte_command(Command.SET_MIXER_AGC, 0, 1 if enabled else 0)

    def set_gain(self, step: int, mode: str = "linearity") -> None:
        """Coupled gain program: disable AGCs then set the three stages
        from the table (AirspyTunerController.setGain)."""
        table = (LINEARITY_GAINS if mode == "linearity"
                 else SENSITIVITY_GAINS)
        if step not in table:
            raise UsbError(f"gain step {step} out of 1-22")
        vga, mixer, lna = table[step]
        self.set_mixer_agc(False)
        self.set_lna_agc(False)
        self.set_vga_gain(vga)
        self.set_mixer_gain(mixer)
        self.set_lna_gain(lna)

    def set_receive_mode(self, on: bool = True) -> None:
        self._byte_command(Command.RECEIVER_MODE, 1 if on else 0, 0)

    def set_packing(self, enabled: bool) -> None:
        self._byte_command(Command.SET_PACKING, 0, 1 if enabled else 0)
