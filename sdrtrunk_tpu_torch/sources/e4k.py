"""Elonics E4000 tuner control plane over an injectable USB transport.

Implements the register state machine of
source/tuner/rtl/e4k/E4KTunerController.java: the 3-/4-bit band PLL
table with Z/X (integer/16-bit-fractional) frequency programming
(setTunedFrequency:356-438, PLL enum:1205-1216), band select with the
SYNTH1 reset workaround and per-band bias (setBand:1008-1042), RF
tracking-filter selection (RFFilter:1318-1430), mixer/IF channel
filters by bandwidth, AGC/gain mode setup, and the initTuner power-on
sequence (init:449-560). No hardware ships in CI — everything is
asserted against a fake register-file transport
(tests/test_tuner_controllers.py pattern).

The E4K rides the same RTL2832 USB bridge as the R820T: register
traffic goes through the RTL's I2C repeater at device address 0xC8.
"""
from __future__ import annotations

import numpy as np

from .rtl2832 import RTL2832Controller

__all__ = ["E4KController", "E4K_PLL_BANDS", "E4K_RF_FILTERS",
           "e4k_pll_solution", "e4k_band", "e4k_rf_filter"]

E4K_I2C_ADDRESS = 0xC8
E4K_MIN_FREQUENCY = 52_000_000
E4K_MAX_FREQUENCY = 2_200_000_000
PLL_Y = 65536                      # 16-bit fractional register

# registers (E4KTunerController.java Register enum)
MASTER1 = 0x00
CLK_INP = 0x05
REF_CLK = 0x06
SYNTH1 = 0x07
SYNTH3 = 0x09
SYNTH4 = 0x0A
SYNTH5 = 0x0B
SYNTH7 = 0x0D
FILT1 = 0x10
FILT2 = 0x11
FILT3 = 0x12
GAIN1 = 0x14
AGC1 = 0x1A
AGC4 = 0x1D
AGC5 = 0x1E
AGC6 = 0x1F
AGC7 = 0x20
DC5 = 0x2D
BIAS = 0x78
CLKOUT_PWDN = 0x7A

MASTER1_RESET = 0x01
MASTER1_NORM_STBY = 0x02
MASTER1_POR_DET = 0x04
SYNTH1_PLL_LOCK = 0x01
BAND_MASK = 0x06
RF_FILTER_MASK = 0x0F
FILT3_DISABLE = 0x20

# (pll index, below-frequency, multiplier, scaled oscillator,
#  3-phase mixing) — PLL enum:1207-1216; the first row whose
# `below` exceeds the target frequency applies
E4K_PLL_BANDS = [
    (0x0F, 72_400_000, 48, 600_000, True),
    (0x0E, 81_200_000, 40, 720_000, True),
    (0x0D, 108_300_000, 32, 900_000, True),
    (0x0C, 162_500_000, 24, 1_200_000, True),
    (0x0B, 216_600_000, 16, 1_800_000, True),
    (0x0A, 325_000_000, 12, 2_400_000, True),
    (0x09, 350_000_000, 8, 3_600_000, True),
    (0x03, 432_000_000, 8, 3_600_000, False),
    (0x02, 667_000_000, 6, 4_800_000, False),
    (0x01, 1_200_000_000, 4, 7_200_000, False),
]

# (filter value, min inclusive, max exclusive) — RFFilter:1320-1360;
# below 350 MHz the tracking filter is bypassed (NO_FILTER = 0)
E4K_RF_FILTERS = [
    (0, 350_000_000, 370_000_000), (1, 370_000_000, 392_500_000),
    (2, 392_500_000, 417_500_000), (3, 417_500_000, 437_500_000),
    (4, 437_500_000, 462_500_000), (5, 462_500_000, 490_000_000),
    (6, 490_000_000, 522_500_000), (7, 522_500_000, 557_500_000),
    (8, 557_500_000, 595_000_000), (9, 595_000_000, 642_500_000),
    (10, 642_500_000, 695_000_000), (11, 695_000_000, 740_000_000),
    (12, 740_000_000, 800_000_000), (13, 800_000_000, 865_000_000),
    (14, 865_000_000, 930_000_000), (15, 930_000_000, 1_135_000_000),
    (0, 1_135_000_000, 1_310_000_000), (1, 1_310_000_000, 1_340_000_000),
    (2, 1_340_000_000, 1_385_000_000), (3, 1_385_000_000, 1_427_500_000),
    (4, 1_427_500_000, 1_452_500_000), (5, 1_452_500_000, 1_475_000_000),
    (6, 1_475_000_000, 1_510_000_000), (7, 1_510_000_000, 1_545_000_000),
    (8, 1_545_000_000, 1_575_000_000), (9, 1_575_000_000, 1_615_000_000),
    (10, 1_615_000_000, 1_650_000_000), (11, 1_650_000_000, 1_670_000_000),
    (12, 1_670_000_000, 1_690_000_000), (13, 1_690_000_000, 1_710_000_000),
    (14, 1_710_000_000, 1_735_000_000), (15, 1_735_000_000, 2_147_000_000),
]


def e4k_pll_solution(frequency: int) -> dict:
    """(pll index, z, x, actual frequency, 3-phase) for a target
    frequency — setTunedFrequency:356-386's Z/X math including the
    52 MHz rounding hack."""
    for idx, below, mult, scaled, three_phase in E4K_PLL_BANDS:
        if frequency < below:
            break
    else:
        idx, below, mult, scaled, three_phase = E4K_PLL_BANDS[0]
    z = (frequency // scaled) & 0xFF
    remainder = frequency - z * scaled
    x = int(remainder / scaled * PLL_Y)

    def actual(xv: int) -> int:
        return scaled * z + int(scaled * (xv / PLL_Y))

    act = actual(x)
    if act < E4K_MIN_FREQUENCY:
        x += 1                          # 52 MHz rounds to 51.999993
        act = actual(x)
    return {"index": idx, "z": z, "x": x, "multiplier": mult,
            "scaled_oscillator": scaled, "actual": act,
            "three_phase": three_phase}


def e4k_band(frequency: int) -> int:
    """SYNTH1 band bits (Band enum:1155-1199): VHF2/VHF3/UHF/L."""
    if frequency < 140_000_000:
        return 0                        # VHF2
    if frequency < 350_000_000:
        return 2                        # VHF3
    if frequency < 1_135_000_000:
        return 4                        # UHF
    return 6                            # L


def e4k_rf_filter(frequency: int) -> int:
    """FILT1 tracking-filter value (RFFilter.fromFrequency:1412)."""
    if frequency < 350_000_000:
        return 0
    for value, lo, hi in E4K_RF_FILTERS:
        if lo <= frequency < hi:
            return value
    raise ValueError(f"no E4K RF filter for {frequency}")


class E4KController:
    """E4K register control through the RTL2832's I2C repeater."""

    def __init__(self, rtl: RTL2832Controller):
        self.rtl = rtl
        # local shadow so masked writes are read-free over the fake
        # transports (the reference reads back over I2C; the shadow
        # mirrors every write we make after init)
        self.shadow: dict[int, int] = {}

    # -- register plumbing ------------------------------------------------

    def write_register(self, register: int, value: int) -> None:
        self.rtl.write_i2c(E4K_I2C_ADDRESS, register, value)
        self.shadow[register] = value & 0xFF

    def write_masked(self, register: int, mask: int, value: int) -> None:
        current = self.shadow.get(register, 0)
        out = (current & ~mask) | (value & mask)
        self.write_register(register, out)

    def read_register(self, register: int) -> int:
        # single-byte register-pointer write (NOT a value write — that
        # would clobber the register), then a one-byte read
        self.rtl.t.control_out(0, E4K_I2C_ADDRESS, 0x600 | 0x10,
                               bytes([register]))
        raw = self.rtl.read_i2c(E4K_I2C_ADDRESS, 1)
        return raw[0] if raw else 0

    # -- power-on ---------------------------------------------------------

    def init_tuner(self) -> None:
        """initTuner:449-560: reset, clocks, AGC thresholds, automatic
        gain modes, DC offset control."""
        self.write_register(MASTER1, MASTER1_RESET | MASTER1_NORM_STBY
                            | MASTER1_POR_DET)
        self.write_register(CLK_INP, 0x00)
        self.write_register(REF_CLK, 0x00)
        self.write_register(CLKOUT_PWDN, 0x96)
        self.write_register(AGC4, 0x10)      # high threshold
        self.write_register(AGC5, 0x04)      # low threshold
        self.write_register(AGC6, 0x1A)      # LNA calibrate + loop rate
        self.write_masked(AGC1, 0x0F, 0x0F)  # AGC mode: IF serial LNA
        self.write_masked(AGC7, 0x01, 0x01)  # mixer gain auto
        self.write_masked(DC5, 0x03, 0x00)   # DC range detector off

    # -- tuning -----------------------------------------------------------

    def set_frequency(self, frequency: int) -> int:
        """Program the PLL + band + RF filter; returns the actual
        (tunable) frequency (setTunedFrequency:356-438)."""
        if not E4K_MIN_FREQUENCY <= frequency <= E4K_MAX_FREQUENCY:
            raise ValueError(
                f"{frequency} outside E4K range "
                f"[{E4K_MIN_FREQUENCY}, {E4K_MAX_FREQUENCY}]")
        sol = e4k_pll_solution(frequency)
        self.write_register(SYNTH7, sol["index"])
        self.write_register(SYNTH3, sol["z"])
        self.write_register(SYNTH4, sol["x"] & 0xFF)
        self.write_register(SYNTH5, (sol["x"] >> 8) & 0xFF)
        self.set_band(sol["actual"])
        self.set_rf_filter(sol["actual"])
        lock = self.read_register(SYNTH1)
        if not lock & SYNTH1_PLL_LOCK:
            raise RuntimeError(
                f"E4K PLL failed to lock at {sol['actual']}")
        return sol["actual"]

    def set_band(self, frequency: int) -> None:
        band = e4k_band(frequency)
        # bias per band (setBand:1016-1029)
        self.write_register(BIAS, 0x3 if band in (0, 2, 4) else 0x0)
        # SYNTH1 reset-then-set workaround for the 325-350 MHz gap
        self.write_masked(SYNTH1, BAND_MASK, 0x0)
        self.write_masked(SYNTH1, BAND_MASK, band)

    def set_rf_filter(self, frequency: int) -> None:
        self.write_masked(FILT1, RF_FILTER_MASK, e4k_rf_filter(frequency))

    # -- filters ----------------------------------------------------------

    # MixerFilter / IFChannelFilter tables (MixerFilter:1433+,
    # register FILT2 high nibble = mixer, FILT3 low 5 bits = channel).
    # The channel filter ladder covers 1.0-5.5 MHz in ~0.1 MHz steps;
    # value 0x1F = narrowest. We mirror the reference's bandwidth ->
    # nearest-value selection for the channel filter.
    _MIXER_FILTERS = [(0x00, 28_800_000), (0x80, 4_800_000),
                      (0x90, 4_400_000), (0xA0, 4_000_000),
                      (0xB0, 3_600_000), (0xC0, 3_200_000),
                      (0xD0, 2_850_000), (0xE0, 2_500_000),
                      (0xF0, 2_200_000)]

    def set_bandwidth(self, bandwidth: int) -> None:
        """setSampleRateFilters:288 role: choose mixer filter by
        bandwidth and enable the channel filter."""
        value = 0x00
        for v, max_bw in self._MIXER_FILTERS:
            if bandwidth < max_bw:
                value = v
        self.write_masked(FILT2, 0xF0, value)
        self.write_masked(FILT3, FILT3_DISABLE, 0x00)   # filter enabled
