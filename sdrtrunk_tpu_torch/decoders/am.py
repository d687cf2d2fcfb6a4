"""AM decoder chain (port of sdrtrunk_tpu/decoders/am.py;
DecodeConfigAM.java:54, 3 kHz bandwidth).

IQ -> baseband FIR -> power squelch -> envelope -> DC removal (0.95) ->
resample 8 kHz, batched over a (C, T) block of channels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import resolve_device
from ..dsp import demod, design, fir, iir
from .nbfm import AUDIO_RATE, _AnalogDecoder

__all__ = ["AMConfig", "AMDecoder"]


@dataclass(frozen=True)
class AMConfig:
    sample_rate: float = 25000.0
    bandwidth: float = 6000.0
    squelch_threshold_db: float = -78.0
    squelch_alpha: float = 0.0004
    audio_rate: float = AUDIO_RATE


class AMDecoder(_AnalogDecoder):

    def __init__(self, config: AMConfig = AMConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        half_bw = config.bandwidth / 2.0
        self._design(design.remez_lowpass(63, half_bw, half_bw + 2000.0,
                                          config.sample_rate),
                     config.sample_rate, config.audio_rate, device)

    def init_state(self) -> dict:
        """Fresh state for one channel (leaves without a channel axis);
        ``dc`` is the DC filter's (x_prev, y_prev)."""
        dev = self.baseband_taps.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return {
            "fir": fir.fir_init(self.baseband_taps.shape[0], device=dev),
            "power": zero.clone(),
            "dc": (zero.clone(), zero.clone()),
            "resamp": fir.resample_init(self.resampler_taps.shape[0],
                                        self.up, device=dev),
        }

    def _front(self, x: torch.Tensor, state: dict):
        """FIR, power squelch, envelope and DC removal at the channel
        rate: (audio, gate, power_db, new state without resamp)."""
        cfg = self.config
        filtered, fir_state = fir.fir_apply(x, self.baseband_taps,
                                            state["fir"])
        gate, power_trace, power_state = demod.power_squelch(
            filtered, cfg.squelch_threshold_db, cfg.squelch_alpha,
            state["power"])
        audio_full, dc_state = iir.dc_removal(demod.am_demodulate(filtered),
                                              0.95, state["dc"])
        return audio_full, gate, power_trace, {
            "fir": fir_state, "power": power_state, "dc": dc_state}
