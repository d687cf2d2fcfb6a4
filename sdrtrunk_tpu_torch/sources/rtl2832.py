"""RTL2832 + R820T tuner control plane over an injectable USB
transport.

Implements the register state machines of
source/tuner/rtl/RTL2832TunerController.java (demod register paging,
sample-rate ratio table, ppm correction, FIR coefficients) and
rtl/r820t/R820TTunerController.java (shadow-register masked writes,
PLL frequency programming with divider/integral/sigma-delta math,
gain tables).  Bulk streaming is out of scope here (no hardware in CI);
everything below is the control-plane logic, testable by asserting the
control-transfer sequences against a RecordingTransport.
"""
from __future__ import annotations


from .usb import UsbError, UsbTransport

__all__ = ["RTL2832Controller", "R820TController", "SAMPLE_RATE_RATIOS",
           "pll_registers", "FREQUENCY_DIVIDERS"]

# demod register pages (RTL2832TunerController.java Page enum)
PAGE_ZERO, PAGE_ONE, PAGE_TEN = 0x0, 0x1, 0xA
REQUEST_ZERO = 0

# rate -> high 16 bits of the 2^22 resampler ratio
# (RTL2832TunerController.java:1246 SampleRate enum)
SAMPLE_RATE_RATIOS = {
    230400: 0x1F40, 240000: 0x1E00, 256000: 0x1C20, 288000: 0x1900,
    300000: 0x1800, 960000: 0x0780, 1024000: 0x0708, 1200000: 0x0600,
    1440000: 0x0500, 1600000: 0x0480, 1800000: 0x0400, 1920000: 0x03C0,
    2048000: 0x0384, 2304000: 0x0320, 2400000: 0x0300, 2560000: 0x02D0,
    2880000: 0x0280,
}

# RTL2832TunerController.java:66 sFIR_COEFFICIENTS
FIR_COEFFICIENTS = bytes([
    0xCA, 0xDC, 0xD7, 0xD8, 0xE0, 0xF2, 0x0E, 0x35, 0x06, 0x50,
    0x9C, 0x0D, 0x71, 0x11, 0x14, 0x71, 0x74, 0x19, 0x41, 0xA5])

TWO_TO_22 = 1 << 22


class RTL2832Controller:
    """RTL2832 demodulator/USB chip control."""

    def __init__(self, transport: UsbTransport):
        self.t = transport
        self.sample_rate = 0
        self.ppm = 0

    # --- register plumbing (write() encoding of
    #     RTL2832TunerController.java:717) ---

    def write_demod(self, page: int, address: int, value: int,
                    length: int) -> None:
        data = value.to_bytes(length, "big")
        self.t.control_out(REQUEST_ZERO, (address << 8) | 0x20,
                           0x10 | page, data)

    def read_demod(self, page: int, address: int, length: int) -> int:
        raw = self.t.control_in(REQUEST_ZERO, (address << 8) | 0x20,
                                page, length)
        return int.from_bytes(raw[:length], "little")

    def write_i2c(self, i2c_address: int, register: int,
                  value: int) -> None:
        """Tuner chip register write through the RTL2832 I2C repeater."""
        self.t.control_out(REQUEST_ZERO, i2c_address,
                           0x600 | 0x10,       # Block.I2C << 8 | write
                           bytes([register, value & 0xFF]))

    def read_i2c(self, i2c_address: int, length: int) -> bytes:
        return self.t.control_in(REQUEST_ZERO, i2c_address, 0x600, length)

    # --- control-plane operations ---

    def set_sample_rate(self, rate: int) -> int:
        """Program the resampler ratio; returns the exact rate set
        (closest supported)."""
        actual = min(SAMPLE_RATE_RATIOS,
                     key=lambda r: abs(r - rate))
        ratio_high = SAMPLE_RATE_RATIOS[actual]
        self.write_demod(PAGE_ONE, 0x9F, ratio_high, 2)
        self.write_demod(PAGE_ONE, 0xA1, 0, 2)
        self.set_sample_rate_correction(0)
        self.reset_demod()
        self.sample_rate = actual
        return actual

    def set_sample_rate_correction(self, ppm: int) -> None:
        """RTL2832TunerController.java:1016"""
        offset = int(-ppm * TWO_TO_22 / 1_000_000)
        self.write_demod(PAGE_ONE, 0x3F, offset & 0xFF, 1)
        self.write_demod(PAGE_ONE, 0x3E, (offset >> 8) & 0xFF, 1)
        self.ppm = ppm

    def reset_demod(self) -> None:
        self.write_demod(PAGE_ONE, 0x01, 0x14, 1)
        self.write_demod(PAGE_ONE, 0x01, 0x10, 1)

    def write_fir(self) -> None:
        for i, coeff in enumerate(FIR_COEFFICIENTS):
            self.write_demod(PAGE_ONE, 0x1C + i, coeff, 1)


# ------------------------------------------------------------- R820T

R820T_I2C_ADDRESS = 0x34
R820T_IF_FREQUENCY = 3_570_000         # R820TTunerController.java:49
R820T_MIN_FREQUENCY = 24_000_000
R820T_MAX_FREQUENCY = 1_766_000_000

# R820TTunerController.java:67 power-on shadow registers 0x00-0x1F
SHADOW_INIT = [
    0x00, 0x00, 0x00, 0x00, 0x00, 0x83, 0x32, 0x75,
    0xC0, 0x40, 0xD6, 0x6C, 0xF5, 0x63, 0x75, 0x68,
    0x6C, 0x83, 0x80, 0x00, 0x0F, 0x00, 0xC0, 0x30,
    0x48, 0xCC, 0x60, 0x00, 0x54, 0xAE, 0x4A, 0xC0]

# (register, mask) pairs — R820TTunerController.java:954 Register enum
REG = {
    "LNA_GAIN": (0x05, 0x1F),
    "MIXER_GAIN": (0x07, 0x1F),
    "VGA_GAIN": (0x0C, 0x9F),
    "REFERENCE_DIVIDER_2": (0x10, 0x10),
    "DIVIDER": (0x10, 0xE0),
    "SIGMA_DELTA_MODULATOR_POWER": (0x12, 0x08),
    "VCO_CURRENT": (0x12, 0xE0),
    "PLL": (0x14, 0x00),
    "SIGMA_DELTA_MODULATOR_LSB": (0x15, 0x00),
    "SIGMA_DELTA_MODULATOR_MSB": (0x16, 0x00),
    "PLL_AUTOTUNE": (0x1A, 0x0C),
    "PLL_AUTOTUNE_VARIANT": (0x1A, 0x08),
}

# (divider#, mixer divider, min Hz, max Hz, reg, integral unit Hz) —
# R820TTunerController.java:1159 FrequencyDivider enum
FREQUENCY_DIVIDERS = [
    (0, 2, 864_000_000, 1_785_600_000, 0x00, 28_800_000),
    (1, 4, 432_000_000, 892_800_000, 0x20, 14_400_000),
    (2, 8, 216_000_000, 460_800_000, 0x40, 7_200_000),
    (3, 16, 108_000_000, 223_200_000, 0x60, 3_600_000),
    (4, 32, 54_000_000, 111_600_000, 0x80, 1_800_000),
    (5, 64, 27_000_000, 55_800_000, 0xA0, 900_000),
    (6, 128, 13_500_000, 27_900_000, 0xC0, 450_000),
    (7, 256, 6_750_000, 13_950_000, 0xE0, 225_000),
]
_VCO_POWER_REFERENCE = 2


def _integral_register(i: int) -> int:
    """Integral enum encoding (I00=0x44, I01=0x84, ..., wraps every 4)."""
    if not 0 <= i <= 31:
        raise UsbError(f"PLL integral {i} out of range")
    n = i + 1
    return ((n & 3) << 6) | ((n >> 2) + 4)


def pll_registers(frequency: int, vco_fine_tune: int = 2) -> dict:
    """Pure PLL math of R820TTunerController.setPLL: returns the
    divider/integral/sdm register values for an oscillator frequency."""
    for (num, _mix, fmin, fmax, _reg, unit) in FREQUENCY_DIVIDERS:
        if fmin <= frequency < fmax:
            break
    else:
        num, fmin, unit = 5, 27_000_000, 900_000   # fromFrequency default
    if vco_fine_tune < _VCO_POWER_REFERENCE:
        num -= 1
    elif vco_fine_tune > _VCO_POWER_REFERENCE:
        num += 1
    delta = frequency - fmin
    integral = int(delta / unit)
    frac = (delta - integral * unit) / unit
    sdm = int(frac * 0x10000) & 0xFFFF
    return {
        "divider": (num << 5) & 0xE0,
        "pll": _integral_register(integral),
        "sdm": sdm,
    }


# R820T LNA gain steps in tenth-dB (R820TTunerController LNAGain enum
# spacing); index is the 4-bit register value
LNA_GAINS_TENTH_DB = [0, 9, 21, 61, 99, 112, 143, 170, 196, 223, 254,
                      280, 297, 328, 338, 364]
MIXER_GAINS_TENTH_DB = [0, 5, 15, 25, 44, 53, 63, 88, 105, 115, 123,
                        139, 152, 158, 161, 153]
VGA_GAINS_TENTH_DB = [i * 35 for i in range(16)]   # ~3.5 dB steps


class R820TController:
    """R820T tuner-chip state machine over an RTL2832 I2C bridge."""

    def __init__(self, rtl: RTL2832Controller):
        self.rtl = rtl
        self.shadow = list(SHADOW_INIT)
        self.frequency = 0

    # masked shadow-register write (R820TTunerController.writeR820TRegister)
    def write_register(self, name: str, value: int) -> None:
        reg, mask = REG[name]
        if mask:
            value = (self.shadow[reg] & ~mask) | (value & mask)
        self.shadow[reg] = value & 0xFF
        self.rtl.write_i2c(R820T_I2C_ADDRESS, reg, value)

    def init_registers(self) -> None:
        """Write registers 0x05..0x1F from the shadow array
        (R820TTunerController.initializeRegisters)."""
        for reg in range(5, len(self.shadow)):
            self.rtl.write_i2c(R820T_I2C_ADDRESS, reg, self.shadow[reg])

    def set_frequency(self, frequency: int,
                      vco_fine_tune: int = 2) -> None:
        """Tune: offset by the 3.57 MHz IF then program the PLL
        (R820TTunerController.java:181,527)."""
        if not R820T_MIN_FREQUENCY <= frequency <= R820T_MAX_FREQUENCY:
            raise UsbError(f"frequency {frequency} outside R820T range")
        osc = frequency + R820T_IF_FREQUENCY
        self.write_register("REFERENCE_DIVIDER_2", 0x00)
        self.write_register("PLL_AUTOTUNE", 0x00)
        self.write_register("VCO_CURRENT", 0x80)
        regs = pll_registers(osc, vco_fine_tune)
        self.write_register("DIVIDER", regs["divider"])
        self.write_register("PLL", regs["pll"])
        if regs["sdm"]:
            self.write_register("SIGMA_DELTA_MODULATOR_POWER", 0x00)
            self.write_register("SIGMA_DELTA_MODULATOR_MSB",
                                (regs["sdm"] >> 8) & 0xFF)
            self.write_register("SIGMA_DELTA_MODULATOR_LSB",
                                regs["sdm"] & 0xFF)
        else:
            self.write_register("SIGMA_DELTA_MODULATOR_POWER", 0x08)
        self.write_register("PLL_AUTOTUNE_VARIANT", 0x08)
        self.frequency = frequency

    def set_lna_gain(self, index: int) -> None:
        if not 0 <= index < len(LNA_GAINS_TENTH_DB):
            raise UsbError(f"LNA gain index {index} out of range")
        self.write_register("LNA_GAIN", 0x10 | index)   # manual mode bit

    def set_mixer_gain(self, index: int) -> None:
        if not 0 <= index < len(MIXER_GAINS_TENTH_DB):
            raise UsbError(f"mixer gain index {index} out of range")
        self.write_register("MIXER_GAIN", index)

    def set_vga_gain(self, index: int) -> None:
        if not 0 <= index < len(VGA_GAINS_TENTH_DB):
            raise UsbError(f"VGA gain index {index} out of range")
        self.write_register("VGA_GAIN", 0x10 | index)
