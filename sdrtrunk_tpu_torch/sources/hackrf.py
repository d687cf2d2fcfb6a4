"""HackRF board control plane over an injectable USB transport.

Mirrors source/tuner/hackrf/HackRFTunerController.java: the vendor
request table (SET_FREQUENCY 16, AMP_ENABLE 17, SET_LNA_GAIN 19,
SET_VGA_GAIN 20, BASEBAND_FILTER_BANDWIDTH_SET), the MHz+Hz split
frequency encoding (HackRFTunerController.java:348), manual sample
rate (frequency + divider, little-endian), and the baseband filter
selection by sample rate.
"""
from __future__ import annotations

import struct

from .usb import UsbError, UsbTransport

__all__ = ["HackRFController", "BASEBAND_FILTERS", "select_baseband_filter"]


class Request:
    SET_TRANSCEIVER_MODE = 1
    BASEBAND_FILTER_BANDWIDTH_SET = 5
    SET_SAMPLE_RATE = 6
    SET_FREQUENCY = 16
    AMP_ENABLE = 17
    BOARD_PARTID_SERIALNO_READ = 18
    SET_LNA_GAIN = 19
    SET_VGA_GAIN = 20
    ANTENNA_ENABLE = 23


class TransceiverMode:
    OFF = 0
    RECEIVE = 1
    TRANSMIT = 2


MIN_FREQUENCY = 10_000_000
MAX_FREQUENCY = 6_000_000_000

# supported baseband filter bandwidths in Hz (MAX5864 table used by the
# reference's BasebandFilter enum)
BASEBAND_FILTERS = [
    1_750_000, 2_500_000, 3_500_000, 5_000_000, 5_500_000, 6_000_000,
    7_000_000, 8_000_000, 9_000_000, 10_000_000, 12_000_000, 14_000_000,
    15_000_000, 20_000_000, 24_000_000, 28_000_000]

LNA_GAIN_MAX = 40      # 8 dB steps
VGA_GAIN_MAX = 62      # 2 dB steps


def select_baseband_filter(sample_rate: int) -> int:
    """Largest filter not exceeding 75% of the sample rate (the hackrf
    convention the reference's HackRFSampleRate enum bakes in)."""
    limit = int(sample_rate * 0.75)
    eligible = [f for f in BASEBAND_FILTERS if f <= limit]
    return eligible[-1] if eligible else BASEBAND_FILTERS[0]


class HackRFController:
    def __init__(self, transport: UsbTransport):
        self.t = transport
        self.frequency = 0
        self.sample_rate = 0
        self.amplifier = False

    def set_frequency(self, frequency: int) -> None:
        """HackRFTunerController.java:348 — two little-endian u32s:
        whole MHz then residual Hz."""
        if not MIN_FREQUENCY <= frequency <= MAX_FREQUENCY:
            raise UsbError(f"frequency {frequency} outside HackRF range")
        mhz = frequency // 1_000_000
        hz = frequency - mhz * 1_000_000
        self.t.control_out(Request.SET_FREQUENCY, 0, 0,
                           struct.pack("<II", mhz, hz))
        self.frequency = frequency

    def set_sample_rate(self, rate: int, divider: int = 1) -> None:
        """setSampleRateManual: u32 frequency + u32 divider, then the
        matching baseband filter."""
        self.t.control_out(Request.SET_SAMPLE_RATE, 0, 0,
                           struct.pack("<II", rate, divider))
        self.set_baseband_filter(select_baseband_filter(rate // divider))
        self.sample_rate = rate // divider

    def set_baseband_filter(self, bandwidth: int) -> None:
        """Bandwidth split across value(low16)/index(high16)
        (HackRFTunerController.java:255)."""
        if bandwidth not in BASEBAND_FILTERS:
            raise UsbError(f"unsupported baseband filter {bandwidth}")
        self.t.control_out(Request.BASEBAND_FILTER_BANDWIDTH_SET,
                           bandwidth & 0xFFFF, (bandwidth >> 16) & 0xFFFF)

    def set_amplifier(self, enabled: bool) -> None:
        self.t.control_out(Request.AMP_ENABLE, 1 if enabled else 0, 0)
        self.amplifier = enabled

    def set_lna_gain(self, gain_db: int) -> None:
        if gain_db % 8 or not 0 <= gain_db <= LNA_GAIN_MAX:
            raise UsbError(f"LNA gain {gain_db} must be 0-40 in 8 dB steps")
        self.t.control_in(Request.SET_LNA_GAIN, 0, gain_db, 1)

    def set_vga_gain(self, gain_db: int) -> None:
        if gain_db % 2 or not 0 <= gain_db <= VGA_GAIN_MAX:
            raise UsbError(f"VGA gain {gain_db} must be 0-62 in 2 dB steps")
        self.t.control_in(Request.SET_VGA_GAIN, 0, gain_db, 1)

    def set_receive_mode(self, on: bool = True) -> None:
        mode = TransceiverMode.RECEIVE if on else TransceiverMode.OFF
        self.t.control_out(Request.SET_TRANSCEIVER_MODE, mode, 0)
