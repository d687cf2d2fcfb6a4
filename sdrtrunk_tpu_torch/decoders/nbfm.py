"""Narrowband FM decoder chain (port of sdrtrunk_tpu/decoders/nbfm.py).

Reference chain (module/decode/nbfm/NBFMDecoder.java:52-66):
    IQ -> baseband FIR -> squelching FM demod -> resample 8 kHz -> audio
with squelch threshold -78 dB and alpha 0.0004 (NBFMDecoder.java:56-58).
Batched over a (C, T) block of channels: FIR, power squelch, FM
discriminator, de-emphasis and the polyphase resampler are plain PyTorch
ops (convolutions, blocked matmuls, elementwise); the gate is carried to
the 8 kHz audio by nearest-sample decimation. All feedback state is
carried, so chunked streaming is exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..dsp import demod, design, fir, iir
from ..runtime import tracing
from ..tree import per_channel

__all__ = ["AUDIO_RATE", "NBFMConfig", "NBFMDecoder"]

AUDIO_RATE = 8000.0  # DecoderFactory.java:109 DEMODULATED_AUDIO_SAMPLE_RATE


@dataclass(frozen=True)
class NBFMConfig:
    sample_rate: float = 25000.0     # per-channel rate from the channelizer
    bandwidth: float = 12500.0       # channel bandwidth (12.5 or 25 kHz)
    squelch_threshold_db: float = -78.0
    squelch_alpha: float = 0.0004
    deemphasis_tau: float = 750e-6
    audio_rate: float = AUDIO_RATE


class _AnalogDecoder(nn.Module):
    """Shared design of the analog chains: the ``baseband_taps`` and
    ``resampler_taps`` buffers, the fs -> 8 kHz resampler ratio, and the
    batched call; each chain supplies its ``_front``."""

    def _design(self, baseband_taps, sample_rate: float, audio_rate: float,
                device) -> None:
        self.register_buffer("baseband_taps", torch.as_tensor(
            np.asarray(baseband_taps, np.float32), device=device))
        frac = Fraction(int(audio_rate), int(sample_rate))
        self.up, self.down = frac.numerator, frac.denominator
        self.register_buffer("resampler_taps", torch.as_tensor(
            np.asarray(fir.resample_taps(self.up, self.down), np.float32),
            device=device))
        self._tpp = self.resampler_taps.shape[0] // self.up

    def _resample(self, audio_full: torch.Tensor, gate: torch.Tensor,
                  state: torch.Tensor):
        """The channel-rate audio and gate at 8 kHz: the polyphase
        resampler, and the gate by nearest-sample decimation, idx =
        (arange(Ka) * down) // up."""
        audio = fir.polyphase_resample(audio_full, self.resampler_taps,
                                       self.up, self.down, state)
        idx = torch.arange(audio.shape[1], device=gate.device) \
            * self.down // self.up
        return audio, gate[:, idx.clamp(0, gate.shape[1] - 1)]

    def batched_call(self, x: torch.Tensor, state: dict
                     ) -> tuple[dict, dict]:
        """Decode a (C, T) block; state leaves carry a leading C axis.
        Returns ({audio (C, T*up/down) float32, audio_gate (same) bool,
        power_db (C, T)}, new state): the chain's front at the channel
        rate (``_front``), then the resampler, whose new state is the
        front's last tpp samples."""
        with tracing.span("step.nbfm_chain"):
            audio_full, gate, power_trace, front_state = self._front(x,
                                                                     state)
            audio, audio_gate = self._resample(audio_full, gate,
                                               state["resamp"])
        outputs = {"audio": audio, "audio_gate": audio_gate,
                   "power_db": power_trace}
        return outputs, {**front_state, "resamp": audio_full[:, -self._tpp:]}

    def forward(self, x: torch.Tensor, state: dict) -> tuple[dict, dict]:
        """Decode one channel's 1-D block (the state in ``init_state``'s
        layout): ``batched_call`` at C = 1."""
        return per_channel(self.batched_call, x, state)


class NBFMDecoder(_AnalogDecoder):

    def __init__(self, config: NBFMConfig = NBFMConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        fs = config.sample_rate
        # baseband low-pass: pass edge at 0.4*bw, stop at 0.56*bw
        # (NBFMDecoder.java:305-337)
        self._design(design.remez_lowpass(63, config.bandwidth * 0.40,
                                          config.bandwidth * 0.56, fs),
                     fs, config.audio_rate, device)
        self.fm_gain = demod.fm_gain(fs, config.bandwidth / 2.0)

    def init_state(self) -> dict:
        """Fresh state for one channel (leaves without a channel axis)."""
        dev = self.baseband_taps.device
        return {
            "fir": fir.fir_init(self.baseband_taps.shape[0], device=dev),
            "prev": torch.zeros((), dtype=torch.complex64, device=dev),
            "power": torch.zeros((), dtype=torch.float32, device=dev),
            "deemph": torch.zeros((), dtype=torch.float32, device=dev),
            "resamp": fir.resample_init(self.resampler_taps.shape[0],
                                        self.up, device=dev),
        }

    def _front(self, x: torch.Tensor, state: dict):
        """FIR, power squelch, FM discriminator and de-emphasis at the
        channel rate: (audio, gate, power_db, new state without resamp)."""
        cfg = self.config
        filtered, fir_state = fir.fir_apply(x, self.baseband_taps,
                                            state["fir"])
        gate, power_trace, power_state = demod.power_squelch(
            filtered, cfg.squelch_threshold_db, cfg.squelch_alpha,
            state["power"])
        audio_full, prev = demod.fm_demodulate(filtered, state["prev"],
                                               self.fm_gain)
        audio_full, deemph_state = iir.deemphasis(
            audio_full, cfg.sample_rate, cfg.deemphasis_tau, state["deemph"])
        return audio_full, gate, power_trace, {
            "fir": fir_state, "prev": prev, "power": power_state,
            "deemph": deemph_state}
