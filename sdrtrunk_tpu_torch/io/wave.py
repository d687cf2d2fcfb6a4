"""IQ / audio WAV file I/O, compatible with the reference's recordings.

The reference records complex baseband as 2-channel (I, Q) 16-bit PCM WAV
(record/wave/ComplexBufferWaveRecorder.java:42) and reads them back through
source/wave/ComplexWaveSource.java:47. We accept 16-bit PCM and 32-bit float
WAV, mono (real) or stereo (complex I/Q), so reference captures are usable as
golden test vectors.
"""
from __future__ import annotations

import struct
import wave as _wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["WaveInfo", "read_complex_wave", "read_real_wave",
           "write_complex_wave", "write_real_wave"]


@dataclass(frozen=True)
class WaveInfo:
    sample_rate: int
    channels: int
    num_frames: int


def _read_wave(path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array shaped (frames, channels), rate)."""
    path = Path(path)
    with open(path, "rb") as fh:
        header = fh.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")

    # wave module handles PCM; handle IEEE float (format 3) manually.
    try:
        with _wave.open(str(path), "rb") as wf:
            rate = wf.getframerate()
            channels = wf.getnchannels()
            width = wf.getsampwidth()
            raw = wf.readframes(wf.getnframes())
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif width == 1:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM width {width}")
        return data.reshape(-1, channels), rate
    except _wave.Error:
        pass

    # IEEE-float WAV: walk chunks by hand.
    with open(path, "rb") as fh:
        fh.seek(12)
        fmt = None
        data = None
        while True:
            chunk_header = fh.read(8)
            if len(chunk_header) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk_header)
            if cid == b"fmt ":
                fmt = fh.read(size)
            elif cid == b"data":
                data = fh.read(size)
            else:
                fh.seek(size + (size & 1), 1)
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunks")
        audio_format, channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == 3 and bits == 32:
            samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif audio_format == 1 and bits == 16:
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        else:
            raise ValueError(f"{path}: unsupported format {audio_format}/{bits}")
        return samples.reshape(-1, channels), rate


def read_complex_wave(path) -> tuple[np.ndarray, int]:
    """Read an IQ WAV -> (complex64 samples, sample_rate)."""
    data, rate = _read_wave(path)
    if data.shape[1] < 2:
        raise ValueError("complex wave requires a 2-channel (I/Q) file")
    iq = (data[:, 0] + 1j * data[:, 1]).astype(np.complex64)
    return iq, rate


def read_real_wave(path) -> tuple[np.ndarray, int]:
    """Read a mono WAV -> (float32 samples, sample_rate)."""
    data, rate = _read_wave(path)
    return np.ascontiguousarray(data[:, 0], dtype=np.float32), rate


def _to_pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")


def write_complex_wave(path, iq: np.ndarray, sample_rate: int) -> None:
    """Write complex64 samples as a 2-channel 16-bit PCM IQ WAV."""
    iq = np.asarray(iq)
    frames = np.stack([iq.real, iq.imag], axis=-1)
    with _wave.open(str(path), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(int(sample_rate))
        wf.writeframes(_to_pcm16(frames).tobytes())


def write_real_wave(path, samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples as mono 16-bit PCM WAV."""
    with _wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(int(sample_rate))
        wf.writeframes(_to_pcm16(np.asarray(samples)).tobytes())


class ComplexWaveWriter:
    """Streaming IQ WAV writer for mid-run recording taps (the role of
    record/wave/ComplexBufferWaveRecorder.java:42 — append complex
    chunks while a capture runs, finalize the header on close)."""

    def __init__(self, path, sample_rate: int):
        self._wf = _wave.open(str(path), "wb")
        self._wf.setnchannels(2)
        self._wf.setsampwidth(2)
        self._wf.setframerate(int(sample_rate))
        self.samples_written = 0

    def write(self, iq: np.ndarray) -> None:
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            frames = np.stack([iq.real, iq.imag], axis=-1)
        else:                         # already (n, 2) float pairs
            frames = iq
        self._wf.writeframes(_to_pcm16(frames).tobytes())
        self.samples_written += len(frames)

    def close(self) -> None:
        self._wf.close()
