"""AFSK1200 correlation demodulator, MPT1327 and the aux decoders (port of
sdrtrunk_tpu/dsp/afsk.py).

Reference chain (dsp/afsk/AFSK1200Decoder.java:42): resample the 8 kHz
FM-demodulated audio to 7200 Hz (6 samples a symbol), correlate against
the 1200 Hz (mark / 1) and 1800 Hz (space / 0) tones, slice mark > space,
then the same boolean bit-timing loop as the LTR demodulator at 6 samples
a symbol. Batched over a (C, T) block. The resampler and the correlators
are ``conv1d``s; only the bit-timing loop is sequential, and it is
``dsp/bit_timing.py``'s: a plain loop on the CPU, the CUDA kernel on the
card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..tree import per_channel
from . import fir
from .bit_timing import BitTimingGeometry, bit_timing

__all__ = ["AFSK1200Demodulator", "AFSKState"]

SAMPLE_RATE = 7200.0
SPS = 6
MARK_HZ = 1200.0
SPACE_HZ = 1800.0
CORRELATION_PERIOD = SPS + 2
AVERAGING_PERIOD = SPS + 1


class AFSKState(NamedTuple):
    """Carried state; batched leaves carry a leading C axis."""
    resample: torch.Tensor        # (C, tpp) float32 resampler history
    corr: torch.Tensor            # (C, 13) float32 correlator history
    window: torch.Tensor          # (C, 12) int8 decisions, newest last
    sampling_point: torch.Tensor  # (C,) float32


class AFSK1200Demodulator(nn.Module):
    """Buffers: ``rtaps`` (the 9/10 resampler's prototype), ``tone_taps``
    (4, 8): mark cos, mark sin, space cos, space sin, and ``avg_taps``
    (7,); ``.to(device)`` moves them."""

    def __init__(self, input_rate: float = 8000.0,
                 timing_gain: float = 1.0 / 3.0, invert: bool = False,
                 device="cuda"):
        super().__init__()
        if input_rate != 8000.0:
            raise ValueError("AFSK1200 expects 8 kHz input audio")
        device = resolve_device(device)
        self.input_rate = input_rate
        self.timing_gain = timing_gain
        self.invert = invert
        self.up, self.down = 9, 10  # 8000 -> 7200
        self.register_buffer("rtaps", torch.as_tensor(
            np.asarray(fir.resample_taps(self.up, self.down), np.float32),
            device=device))
        n = np.arange(CORRELATION_PERIOD)
        tones = [f(2.0 * np.pi * freq / SAMPLE_RATE * n)
                 for freq in (MARK_HZ, SPACE_HZ) for f in (np.cos, np.sin)]
        self.register_buffer("tone_taps", torch.as_tensor(
            np.stack(tones).astype(np.float32), device=device))
        self.register_buffer("avg_taps", torch.as_tensor(
            (np.ones(AVERAGING_PERIOD) / AVERAGING_PERIOD)
            .astype(np.float32), device=device))
        # symbol-recovery geometry at 6 sps
        self.window_len = 2 * SPS
        self.int_sps = SPS
        self.half_sps = SPS // 2
        self.zc_len = SPS + 1
        self.zc_ideal = SPS / 2.0
        self.geometry = BitTimingGeometry(
            window_len=self.window_len, vote_start=self.half_sps,
            vote_len=self.int_sps, zc_len=self.zc_len,
            zc_ideal=self.zc_ideal, sps=float(SPS), timing_gain=timing_gain,
            two_crossings=False)
        # total correlator history per branch
        self._corr_len = CORRELATION_PERIOD + AVERAGING_PERIOD - 1
        self._tpp = self.rtaps.shape[0] // self.up

    def init_state(self) -> AFSKState:
        """Fresh state for one channel (leaves without a channel axis)."""
        dev = self.rtaps.device
        return AFSKState(
            resample=fir.resample_init(self.rtaps.shape[0], self.up,
                                       device=dev),
            corr=torch.zeros((self._corr_len - 1,), dtype=torch.float32,
                             device=dev),
            window=torch.zeros((self.window_len,), dtype=torch.int8,
                               device=dev),
            sampling_point=torch.tensor(float(SPS + self.half_sps),
                                        dtype=torch.float32, device=dev))

    def _correlate(self, padded: torch.Tensor) -> torch.Tensor:
        """padded: (C, L) 7200 Hz audio with corr_len - 1 history samples
        in front -> mark-minus-space correlation power, exact for every
        output past the history (which is cut off). Each FIR starts from
        zero history, as the reference's one-shot ``fir_filter`` does."""
        c = padded.shape[0]
        iq = fir.fir_filter_bank(padded, self.tone_taps)        # (C, 4, L)
        power = (iq * iq).reshape(c, 2, 2, -1).sum(2)           # mark, space
        avg = fir.fir_filter(power.reshape(2 * c, -1), self.avg_taps)
        avg = avg.reshape(c, 2, -1)
        return (avg[:, 0] - avg[:, 1])[:, self._corr_len - 1:]

    def front(self, audio: torch.Tensor, state: AFSKState):
        """What precedes the timing loop: the 9/10 resampler and the tone
        correlators. Returns (mark - space (C, T * 9 / 10), new resample
        history, new correlator history)."""
        audio = audio.to(torch.float32)
        resampled = fir.polyphase_resample(audio, self.rtaps, self.up,
                                           self.down, state.resample)
        rstate = torch.cat([state.resample, audio], 1)[:, -self._tpp:]
        padded = torch.cat([state.corr, resampled], 1)
        return (self._correlate(padded), rstate,
                padded[:, -(self._corr_len - 1):])

    def batched(self, audio: torch.Tensor, state: AFSKState):
        """(C, T) block of 8 kHz audio, T a multiple of 10 (the
        resampler's ``down``) -> (bits (C, T * 9 / 10) int8, valid (same)
        bool, new state); ``bits`` is 0 where ``valid`` is not set."""
        diff, rstate, corr = self.front(audio, state)
        bits, valid, window, sp = bit_timing(
            self.geometry, diff, state.window, state.sampling_point,
            invert=self.invert)
        return bits, valid, AFSKState(rstate, corr, window, sp)

    def forward(self, audio: torch.Tensor, state: AFSKState | None = None):
        """One channel's 1-D 8 kHz audio block, its length a multiple of
        10 -> (bits, valid, new state), the state in ``init_state``'s
        layout (None: a fresh one); ``batched`` at C = 1."""
        if state is None:
            state = self.init_state()
        return per_channel(self.batched, audio, state)
