"""DMR decoder chain (port of sdrtrunk_tpu/decoders/dmr.py).

Reference chain (module/decode/dmr/DMRDecoder.java:54,183-188): the same
decision-directed DQPSK core as P25 C4FM, with baseband filter pass 5100 /
stop 6500 and symbol timing gain 0.4 (DMRDecoder.java:58). The DQPSK
kernel (csrc/dqpsk.cu) takes the gain at run time.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..dsp import design
from ..dsp.psk import DQPSKDemodulator
from .dqpsk_chain import DQPSKChainDecoder

__all__ = ["DMRConfig", "DMRDecoder"]


@dataclass(frozen=True)
class DMRConfig:
    sample_rate: float = 25000.0
    symbol_rate: float = 4800.0
    pass_hz: float = 5100.0
    stop_hz: float = 6500.0
    sample_counter_gain: float = 0.4   # DMRDecoder.java:58
    pll_bandwidth: float = 300.0
    agc_window: int = 32


class DMRDecoder(DQPSKChainDecoder):
    """Taps (``baseband_taps``) and the interpolator bank are buffers."""

    def __init__(self, config: DMRConfig = DMRConfig(), device="cuda"):
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
