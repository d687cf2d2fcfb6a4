"""Zero-crossing FSK symbol recovery, LTR / Passport sub-audible 300 baud
(port of sdrtrunk_tpu/dsp/fsk.py).

Reference chain (dsp/fsk/LTRDecoder.java:52): DC removal -> 300/500 Hz
remez low-pass -> slicing at 0 -> majority-vote symbol decision with a
zero-crossing timing error. Batched over a (C, T) block of 8 kHz audio.
The DC removal is a single pole solved without a loop (``iir.single_pole``,
blocked matmuls), the low-pass one ``conv1d``; only the bit-timing loop is
sequential, and it is ``dsp/bit_timing.py``'s: a plain loop on the CPU,
the CUDA kernel on the card.

Geometry at 8 kHz / 300 baud (sps = 26.667): a delay line of
floor(2 * sps) = 53 decisions; the bit by majority over [13, 40) of the
line (0.5 to 1.5 symbols back); the timing error from the crossings among
the newest ceil(sps) = 27 decisions against the ideal position sps / 2.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..tree import per_channel
from . import design, fir, iir
from .bit_timing import BitTimingGeometry, bit_timing

__all__ = ["LTRFSKDemodulator", "LTRFSKState"]


class LTRFSKState(NamedTuple):
    """Carried state; batched leaves carry a leading C axis."""
    window: torch.Tensor          # (C, W) int8 slicer decisions, newest last
    sampling_point: torch.Tensor  # (C,) float32 mid-symbol counter
    dc: torch.Tensor              # (C,) float32 DC-removal accumulator
    fir: torch.Tensor             # (C, 62) float32 low-pass delay line


class LTRFSKDemodulator(nn.Module):
    """The ``taps`` buffer holds the low-pass; ``.to(device)`` moves it."""

    def __init__(self, sample_rate: float = 8000.0,
                 symbol_rate: float = 300.0,
                 timing_gain: float = 1.0 / 3.0,   # COARSE_TIMING_GAIN
                 dc_ratio: float = 0.99999, device="cuda"):
        super().__init__()
        self.sample_rate = sample_rate
        self.symbol_rate = symbol_rate
        self.timing_gain = timing_gain
        self.dc_ratio = dc_ratio
        self.sps = sample_rate / symbol_rate
        self.window_len = int(math.floor(2.0 * self.sps))
        self.int_sps = int(self.sps + 0.5)
        self.half_sps = int(self.sps / 2.0 + 0.5)
        self.zc_len = int(math.ceil(self.sps))
        self.zc_ideal = self.sps / 2.0
        self.geometry = BitTimingGeometry(
            window_len=self.window_len, vote_start=self.half_sps,
            vote_len=self.int_sps, zc_len=self.zc_len,
            zc_ideal=self.zc_ideal, sps=self.sps, timing_gain=timing_gain,
            two_crossings=True)
        self.register_buffer("taps", torch.as_tensor(
            np.asarray(design.remez_lowpass(63, 300.0, 500.0, sample_rate,
                                            0.01, 0.03), np.float32),
            device=resolve_device(device)))

    def init_state(self) -> LTRFSKState:
        """Fresh state for one channel (leaves without a channel axis)."""
        dev = self.taps.device
        return LTRFSKState(
            window=torch.zeros((self.window_len,), dtype=torch.int8,
                               device=dev),
            sampling_point=torch.tensor(self.sps + self.half_sps,
                                        dtype=torch.float32, device=dev),
            dc=torch.zeros((), dtype=torch.float32, device=dev),
            fir=fir.fir_init(self.taps.shape[0], torch.float32, dev))

    def front(self, audio: torch.Tensor, state: LTRFSKState):
        """What precedes the timing loop: single-pole DC removal, y[t] =
        x[t] - acc[t] with acc[t + 1] = acc[t] + (1 - ratio) * y[t] (so acc
        is the single pole of x, read before its update), and the
        low-pass. Returns (filtered (C, T), new dc (C,), new fir)."""
        audio = audio.to(torch.float32)
        acc = iir.single_pole(audio, 1.0 - self.dc_ratio, state.dc)
        no_dc = audio - torch.cat([state.dc[:, None], acc[:, :-1]], 1)
        filtered, fir_state = fir.fir_apply(no_dc, self.taps, state.fir)
        return filtered, acc[:, -1], fir_state

    def batched(self, audio: torch.Tensor, state: LTRFSKState):
        """Demodulate a (C, T) block of 8 kHz audio -> (bits (C, T) int8,
        valid (C, T) bool, new state); ``bits`` is 0 where ``valid`` is
        not set."""
        filtered, dc, fir_state = self.front(audio, state)
        bits, valid, window, sp = bit_timing(
            self.geometry, filtered, state.window, state.sampling_point)
        return bits, valid, LTRFSKState(window, sp, dc, fir_state)

    def forward(self, audio: torch.Tensor, state: LTRFSKState | None = None):
        """One channel's 1-D 8 kHz audio block -> (bits, valid, new state),
        the state in ``init_state``'s layout (None: a fresh one);
        ``batched`` at C = 1."""
        if state is None:
            state = self.init_state()
        return per_channel(self.batched, audio, state)
