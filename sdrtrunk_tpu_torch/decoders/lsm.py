"""P25 Phase 1 LSM decoder chain (port of sdrtrunk_tpu/decoders/lsm.py).

Reference chain (module/decode/p25/phase1/P25P1DecoderLSM.java:52-90):
the C4FM baseband filter (pass 5100 / stop 6500, ripple 0.01), power
monitor and feed-forward AGC, then Gardner-timed DQPSK symbol recovery
with sample counter gain 0.3 (simulcast sites smear symbol timing, which
the Gardner detector tracks).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dsp import design

from .. import resolve_device
from ..dsp.psk import GardnerDQPSKDemodulator
from .dqpsk_chain import DQPSKChainDecoder

__all__ = ["LSMConfig", "LSMDecoder"]


@dataclass(frozen=True)
class LSMConfig:
    sample_rate: float = 25000.0
    symbol_rate: float = 4800.0
    pass_hz: float = 5100.0
    stop_hz: float = 6500.0
    sample_counter_gain: float = 0.3   # P25P1DecoderLSM.java:52
    pll_bandwidth: float = 300.0
    agc_window: int = 32


class LSMDecoder(DQPSKChainDecoder):
    """Taps (``baseband_taps``) and the interpolator bank are buffers."""

    def __init__(self, config: LSMConfig = LSMConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        taps = design.remez_lowpass(63, config.pass_hz, config.stop_hz,
                                    config.sample_rate, 0.01, 0.01)
        self.register_buffer("baseband_taps", torch.as_tensor(
            np.asarray(taps, np.float32), device=device))
        self.demod = GardnerDQPSKDemodulator(
            sample_rate=config.sample_rate,
            symbol_rate=config.symbol_rate,
            sample_counter_gain=config.sample_counter_gain,
            loop_bandwidth=config.pll_bandwidth, device=device)
