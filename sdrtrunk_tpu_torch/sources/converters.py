"""Raw tuner sample-format converters (host-side, NumPy).

Decode-table equivalents of the reference's USB buffer converters:
- RTL-2832 8-bit unsigned: (x - 127) / 128
  (source/tuner/usb/converter/ByteSampleConverter.java:33)
- HackRF 8-bit signed: x / 128
  (source/tuner/usb/converter/SignedByteSampleConverter.java:33)
- Airspy 12-bit unpacked/packed: ((x & 0xFFF) - 2048) / 2048
  (source/tuner/airspy/AirspySampleConverter.java:28,156-158)
- 16-bit PCM (FCD / sound-card): x / 32768

These run on the ingest host thread before device upload (the analog of the
libusb-thread conversion in the reference); they are plain vectorized NumPy
because the data arrives on host anyway and the per-byte table lookups the
reference uses are just affine maps here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rtl_bytes_to_iq", "signed_bytes_to_iq",
           "airspy_unpacked_to_floats", "airspy_packed_to_floats",
           "pcm16_to_iq", "interleave_to_complex"]


def interleave_to_complex(floats: np.ndarray) -> np.ndarray:
    """i0,q0,i1,q1,... float stream -> complex64 array."""
    floats = np.asarray(floats, dtype=np.float32)
    if floats.size % 2:
        raise ValueError(
            "interleave_to_complex needs an even-length I/Q stream; got "
            f"{floats.size} floats — split raw buffers on sample boundaries "
            "(carry the odd trailing float to the next chunk)")
    return (floats[0::2] + 1j * floats[1::2]).astype(np.complex64)


def rtl_bytes_to_iq(raw: bytes | np.ndarray) -> np.ndarray:
    """RTL-2832 8-bit unsigned interleaved IQ -> complex64."""
    b = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) \
        else np.asarray(raw, dtype=np.uint8)
    floats = (b.astype(np.float32) - 127.0) / 128.0
    return interleave_to_complex(floats)


def signed_bytes_to_iq(raw: bytes | np.ndarray) -> np.ndarray:
    """HackRF 8-bit signed interleaved IQ -> complex64."""
    b = np.frombuffer(raw, dtype=np.int8) if isinstance(raw, (bytes, bytearray)) \
        else np.asarray(raw, dtype=np.int8)
    return interleave_to_complex(b.astype(np.float32) / 128.0)


def _scale12(v: np.ndarray) -> np.ndarray:
    return ((v & 0xFFF).astype(np.float32) - 2048.0) / 2048.0


def airspy_unpacked_to_floats(raw: bytes | np.ndarray) -> np.ndarray:
    """Airspy 12-bit-in-16-bit-word (unpacked) real samples -> float32."""
    w = np.frombuffer(raw, dtype="<u2") if isinstance(raw, (bytes, bytearray)) \
        else np.asarray(raw, dtype=np.uint16)
    return _scale12(w.astype(np.int64))


def airspy_packed_to_floats(raw: bytes | np.ndarray) -> np.ndarray:
    """Airspy packed mode: two 12-bit samples per 3 bytes -> float32.

    Packing (AirspySampleConverter.convertPacked): each 32-bit little-endian
    word holds samples back to back; we unpack from the byte stream in
    3-byte groups: first = b0 | (b1 & 0x0F) << 8 is NOT the airspy layout —
    airspy packs MSB-first within the word: first = word >> 20,
    second = (word >> 8) & 0xFFF, leftovers chain into the next word. For
    simplicity and parity we implement the 32-bit-word form: each uint32
    yields samples (w >> 20) & 0xFFF and (w >> 8) & 0xFFF, with the low
    8 bits joining the next word (matching the reference's bit cursor).
    """
    b = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) \
        else np.asarray(raw, dtype=np.uint8)
    # Flatten to a bitstream of 12-bit big-endian-within-word samples:
    # process per 3 bytes = 2 samples (the canonical 12-bit packing).
    n3 = (b.size // 3) * 3
    b = b[:n3].reshape(-1, 3).astype(np.int64)
    first = (b[:, 0] << 4) | (b[:, 1] >> 4)
    second = ((b[:, 1] & 0x0F) << 8) | b[:, 2]
    out = np.empty(first.size * 2, dtype=np.int64)
    out[0::2] = first
    out[1::2] = second
    return _scale12(out)


def pcm16_to_iq(raw: bytes | np.ndarray) -> np.ndarray:
    """16-bit signed little-endian interleaved IQ (FCD, sound card)."""
    w = np.frombuffer(raw, dtype="<i2") if isinstance(raw, (bytes, bytearray)) \
        else np.asarray(raw, dtype=np.int16)
    return interleave_to_complex(w.astype(np.float32) / 32768.0)
