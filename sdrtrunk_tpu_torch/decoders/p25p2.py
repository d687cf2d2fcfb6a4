"""P25 Phase 2 HDQPSK decoder chain (port of sdrtrunk_tpu/decoders/p25p2.py).

Reference chain (module/decode/p25/phase2/P25P2DecoderHDQPSK.java:62-89):
baseband filter pass 6500 / stop 7200, ripple 0.005; Gardner-timed DQPSK
at 6000 baud with symbol timing gain 0.1 (``timing="gardner"``, the
default); ``timing="decision"`` runs the decision-directed DQPSK loop
instead (W = 16 at the 50 kHz rate, the DQPSK kernel's W = 16
instantiation on the card), sharper on clean non-simulcast signals, as the
reference's option does. Below 40 kHz the channel stream
is zero-stuffed x2 (the reference demands a 50 kHz channel rate for Phase
2; at 25 kHz the 6000-baud timing loop runs out of resolution) and the
baseband FIR, designed at the doubled rate, removes the images.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dsp import design

from .. import resolve_device
from ..dsp.psk import DQPSKDemodulator, GardnerDQPSKDemodulator
from .dqpsk_chain import DQPSKChainDecoder

__all__ = ["P25P2Config", "P25P2Decoder"]


@dataclass(frozen=True)
class P25P2Config:
    sample_rate: float = 50000.0
    symbol_rate: float = 6000.0
    pass_hz: float = 6500.0
    stop_hz: float = 7200.0
    sample_counter_gain: float = 0.1   # P25P2DecoderHDQPSK.java:62
    pll_bandwidth: float = 300.0
    agc_window: int = 32
    timing: str = "gardner"            # "gardner" | "decision"


class P25P2Decoder(DQPSKChainDecoder):
    """Taps (``baseband_taps``) and the interpolator bank are buffers."""

    def __init__(self, config: P25P2Config = P25P2Config(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.upsample = 2 if config.sample_rate < 40000.0 else 1
        eff_rate = config.sample_rate * self.upsample
        taps = design.remez_lowpass(63, config.pass_hz, config.stop_hz,
                                    eff_rate, 0.005, 0.005)
        self.register_buffer("baseband_taps", torch.as_tensor(
            np.asarray(taps, np.float32), device=device))
        demod_cls = (GardnerDQPSKDemodulator if config.timing == "gardner"
                     else DQPSKDemodulator)
        self.demod = demod_cls(
            sample_rate=eff_rate,
            symbol_rate=config.symbol_rate,
            sample_counter_gain=config.sample_counter_gain,
            loop_bandwidth=config.pll_bandwidth, device=device)
