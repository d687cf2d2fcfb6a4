"""P25 Phase 1 C4FM decoder chain (port of sdrtrunk_tpu/decoders/c4fm.py).

Reference chain (module/decode/p25/phase1/P25P1DecoderC4FM.java:101):
    IQ 25-50 kHz -> remez baseband LPF (pass 5100 / stop 6500, ripple 0.01)
    -> power monitor -> feed-forward AGC (window 32)
    -> decision-directed DQPSK demod (PLL BW_300, timing gain 0.3) -> dibits
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dsp import design

from .. import resolve_device
from ..dsp.psk import DQPSKDemodulator
from .dqpsk_chain import DQPSKChainDecoder

__all__ = ["C4FMConfig", "C4FMDecoder"]


@dataclass(frozen=True)
class C4FMConfig:
    sample_rate: float = 25000.0
    symbol_rate: float = 4800.0
    pass_hz: float = 5100.0
    stop_hz: float = 6500.0
    sample_counter_gain: float = 0.3   # P25P1DecoderC4FM.java:48
    pll_bandwidth: float = 300.0       # PLLBandwidth.BW_300
    agc_window: int = 32


class C4FMDecoder(DQPSKChainDecoder):
    """Taps (``baseband_taps``) and the interpolator bank are buffers."""

    def __init__(self, config: C4FMConfig = C4FMConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        taps = design.remez_lowpass(63, config.pass_hz, config.stop_hz,
                                    config.sample_rate, 0.01, 0.01)
        self.register_buffer("baseband_taps", torch.as_tensor(
            np.asarray(taps, np.float32), device=device))
        self.demod = DQPSKDemodulator(
            sample_rate=config.sample_rate,
            symbol_rate=config.symbol_rate,
            sample_counter_gain=config.sample_counter_gain,
            loop_bandwidth=config.pll_bandwidth, device=device)
