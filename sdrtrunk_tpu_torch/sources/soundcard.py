"""Sound-card sample sources (role of source/mixer/: MixerManager.java,
ComplexMixerSource / RealMixerSource).

The FCD Pro+ and sound-card-fed discriminator taps deliver samples as
PCM over an audio capture device.  Capture hardware is abstracted as a
``read(frames:int) -> bytes`` callable (bind an ALSA/pyaudio reader on a
desktop; tests bind a scripted byte stream), and this module owns the
real logic: PCM16 little-endian decode, mono -> real / stereo -> complex
channel mapping, device registry with capability-based selection.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = ["MixerChannelMode", "MixerSpec", "SoundCardSource",
           "MixerManager"]


class MixerChannelMode:
    MONO = "mono"          # one channel -> real samples
    STEREO_IQ = "stereo"   # L=I, R=Q -> complex samples


@dataclass(frozen=True)
class MixerSpec:
    """One capture device's capabilities (MixerManager enumeration)."""
    name: str
    sample_rate: int
    channels: int

    @property
    def supports_iq(self) -> bool:
        return self.channels >= 2


class SoundCardSource:
    """PCM16 capture -> float32 real or complex64 IQ stream."""

    def __init__(self, read: Callable[[int], bytes], sample_rate: int,
                 mode: str = MixerChannelMode.MONO,
                 swap_iq: bool = False):
        self.read = read
        self.sample_rate = sample_rate
        self.mode = mode
        self.swap_iq = swap_iq
        self._remainder = b""

    @property
    def bytes_per_frame(self) -> int:
        return 4 if self.mode == MixerChannelMode.STEREO_IQ else 2

    def get_samples(self, n_frames: int) -> np.ndarray:
        """Read and decode n_frames; short reads return fewer samples
        (end of capture)."""
        want = n_frames * self.bytes_per_frame - len(self._remainder)
        raw = self._remainder + (self.read(max(want, 0)) if want > 0
                                 else b"")
        bpf = self.bytes_per_frame
        usable = (len(raw) // bpf) * bpf
        self._remainder = raw[usable:]
        pcm = np.frombuffer(raw[:usable], dtype="<i2").astype(
            np.float32) / 32768.0
        if self.mode == MixerChannelMode.MONO:
            return pcm
        pairs = pcm.reshape(-1, 2)
        i, q = (pairs[:, 1], pairs[:, 0]) if self.swap_iq \
            else (pairs[:, 0], pairs[:, 1])
        return (i + 1j * q).astype(np.complex64)


class MixerManager:
    """Registry + capability-based selection of capture devices
    (MixerManager.java's device discovery role, with discovery
    injectable)."""

    def __init__(self):
        self._devices: dict[str, tuple[MixerSpec, Callable]] = {}

    def register(self, spec: MixerSpec,
                 reader_factory: Callable[[], Callable[[int], bytes]]
                 ) -> None:
        self._devices[spec.name] = (spec, reader_factory)

    @property
    def devices(self) -> list[MixerSpec]:
        return [spec for spec, _ in self._devices.values()]

    def open(self, name: str, mode: str | None = None) -> SoundCardSource:
        if name not in self._devices:
            raise KeyError(f"no capture device {name!r}; have "
                           f"{sorted(self._devices)}")
        spec, factory = self._devices[name]
        if mode is None:
            mode = (MixerChannelMode.STEREO_IQ if spec.supports_iq
                    else MixerChannelMode.MONO)
        if mode == MixerChannelMode.STEREO_IQ and not spec.supports_iq:
            raise ValueError(f"{name} is mono-only; cannot capture IQ")
        return SoundCardSource(factory(), spec.sample_rate, mode)
