"""Shared DQPSK decoder chain (port of sdrtrunk_tpu/decoders/dqpsk_chain.py).

Baseband FIR -> power monitor -> 32-sample feed-forward AGC -> DQPSK
symbol recovery, batched over a (C, T) block of channels; called on one
channel's 1-D block, it runs that path at C = 1. Subclasses set
``config`` (with ``agc_window``), the ``baseband_taps`` buffer and the
``demod`` submodule (a ``DQPSKDemodulator`` or a
``GardnerDQPSKDemodulator``). A subclass may set ``upsample`` = 2 to
zero-stuff the channel stream before the baseband FIR, which then doubles
as the interpolation filter (P25 Phase 2's 50 kHz channel rate).
"""
from __future__ import annotations

import torch
from torch import nn

from ..dsp import agc, demod, fir
from ..runtime import tracing
from ..tree import per_channel

__all__ = ["DQPSKChainDecoder"]


class DQPSKChainDecoder(nn.Module):

    upsample = 1

    def init_state(self) -> dict:
        """Fresh state for one channel (leaves without a channel axis)."""
        dev = self.baseband_taps.device
        return {
            "fir": fir.fir_init(self.baseband_taps.shape[0], device=dev),
            "agc": agc.feed_forward_agc_init(self.config.agc_window,
                                             device=dev),
            "power": torch.zeros((), dtype=torch.float32, device=dev),
            "psk": self.demod.init_state(),
        }

    def _front(self, x: torch.Tensor, state: dict):
        """(Zero-stuff +) FIR + power monitor + AGC over a (C, T) block."""
        if self.upsample > 1:
            up = self.upsample
            c, t = x.shape
            stuffed = torch.zeros((c, t * up), dtype=x.dtype, device=x.device)
            stuffed[:, ::up] = x * up       # images removed by the LPF
            x = stuffed
        filtered, fir_state = fir.fir_apply(x, self.baseband_taps,
                                            state["fir"])
        power_trace, power_state = demod.power_db(filtered, 0.0004,
                                                  state["power"])
        leveled, agc_state = agc.feed_forward_agc(
            filtered, state["agc"], self.config.agc_window)
        return (leveled, power_trace), {"fir": fir_state, "agc": agc_state,
                                        "power": power_state}

    def batched_call(self, x: torch.Tensor, state: dict
                     ) -> tuple[dict, dict]:
        """Decode a (C, T) block; state leaves carry a leading C axis."""
        with tracing.span("step.c4fm_front"):
            (leveled, power_trace), front_state = self._front(x, state)
        with tracing.span("step.dqpsk"):
            dibits, valid, psk_state = self.demod.batched(leveled,
                                                          state["psk"])
        outputs = {"dibits": dibits, "valid": valid,
                   "power_db": power_trace, "pll_freq": psk_state.pll_freq}
        return outputs, {**front_state, "psk": psk_state}

    def forward(self, x: torch.Tensor, state: dict) -> tuple[dict, dict]:
        """Decode one channel's 1-D block; the state in ``init_state``'s
        layout. ``batched_call`` at C = 1, so a CUDA tensor launches the
        symbol kernel once."""
        return per_channel(self.batched_call, x, state)
