"""Boolean bit-timing loop shared by the zero-crossing FSK demodulator
(dsp/fsk.py, LTR family, 300 baud) and the AFSK1200 demodulator
(dsp/afsk.py, MPT1327 and the aux decoders).

Both reference demodulators end in the same per-sample feedback loop, a
``lax.scan`` over ``_step`` (sdrtrunk_tpu/dsp/fsk.py:64-96 and :108,
sdrtrunk_tpu/dsp/afsk.py:95-112 and :129): a delay line of W slicer
decisions, a counter that runs down by one a sample, and, where it falls
below 1, a symbol: the bit by majority vote over the middle of the line,
and a timing correction from the zero crossings among the newest
decisions. The two differ only in geometry and in the two-crossing rule
(``BitTimingGeometry``).

``bit_timing`` picks the path from where the input lies: a CPU tensor runs
the plain loop below (a Python loop over samples, batched over channels),
any other tensor launches the CUDA kernel of ``dsp/bit_timing_cuda.py`` or
raises. There is no fallback from the kernel to the loop.

Rounding. The reference's update ``sp + sps + error * gain`` is
``(sp + sps) + error * gain`` in float32, whose last product and sum
XLA:CPU contracts into one fused multiply-add; the loop and the kernel
(built with ``--fmad=false``) take it as the float64 product plus sum
rounded once to float32, as the PSK loops do (dsp/psk.py).

Outputs: ``bits`` (C, T) int8 and ``valid`` (C, T) bool. ``bits`` holds
the voted bit where ``valid`` is set and 0 elsewhere (the reference's scan
emits a vote at every sample; every caller reads ``bits[valid]`` only).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["BitTimingGeometry", "bit_timing", "bit_timing_plain"]


def _f32(v: float) -> float:
    """v rounded to float32: the value the reference's weakly typed
    constants take inside float32 ops."""
    return float(np.float32(v))


@dataclass(frozen=True)
class BitTimingGeometry:
    """What tells the two demodulators' timing loops apart.

    window_len W: decisions kept, newest last (the plain loop takes any W;
    the kernel holds the line in ceil(W / 64) 64-bit words, up to eight,
    so it takes W <= 512: ``bit_timing_cuda.MAX_WINDOW``). The vote is over
    [vote_start, vote_start + vote_len) of the line (majority:
    sum > vote_len // 2). Crossings are looked for between neighbours of
    the newest zc_len decisions; crossing i lies between zc[i] and
    zc[i + 1] and gives the error (i + 0.5) - zc_ideal. With exactly one
    crossing that is the error; with exactly two, ``two_crossings`` takes
    the one nearer the ideal (the last on a tie; the FSK rule) or no error
    (AFSK); otherwise the error is 0. A symbol adds sps + error *
    timing_gain to the counter.
    """
    window_len: int
    vote_start: int
    vote_len: int
    zc_len: int
    zc_ideal: float
    sps: float
    timing_gain: float
    two_crossings: bool

    def __post_init__(self):
        if not 2 <= self.zc_len <= self.window_len:
            raise ValueError(f"window_len {self.window_len} and zc_len "
                             f"{self.zc_len} must satisfy 2 <= zc_len <= "
                             "window_len")
        if self.vote_start < 0 \
                or self.vote_start + self.vote_len > self.window_len:
            raise ValueError("the vote window lies outside the delay line")

    def constants(self) -> dict[str, float]:
        """The loop's float32 constants, shared by the plain loop and the
        kernel."""
        return {"zc_ideal": _f32(self.zc_ideal), "sps": _f32(self.sps),
                "gain": _f32(self.timing_gain)}


def bit_timing(geom: BitTimingGeometry, x: torch.Tensor,
               window: torch.Tensor, sampling_point: torch.Tensor,
               invert: bool = False):
    """Slice x (C, T) float32 at 0 (decision = x > 0, flipped by
    ``invert``) and run the timing loop from (window (C, W) int8,
    sampling_point (C,) float32). Returns (bits (C, T) int8, valid (C, T)
    bool, new window, new sampling_point). A CPU tensor runs the plain
    loop; any other tensor goes to the CUDA kernel, which launches or
    raises."""
    if x.device.type == "cpu":
        return bit_timing_plain(geom, x, window, sampling_point, invert)
    from .bit_timing_cuda import bit_timing_cuda
    return bit_timing_cuda(geom, x, window, sampling_point, invert)


def bit_timing_plain(geom: BitTimingGeometry, x: torch.Tensor,
                     window: torch.Tensor, sampling_point: torch.Tensor,
                     invert: bool = False):
    """Plain PyTorch version of the kernel: the reference's ``_step`` over
    a Python loop of samples, batched over channels. The delay line at
    sample t is a slice of [window, decisions], so only the counter is
    carried; a sample on which no channel has a symbol due skips the
    symbol step, which would leave every channel's state as it is."""
    c, t = x.shape
    dev = x.device
    w, zl = geom.window_len, geom.zc_len
    k = geom.constants()
    decisions = (x > 0.0)
    if invert:
        decisions = ~decisions
    line = torch.cat([window.to(torch.int8), decisions.to(torch.int8)], 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sp = sampling_point
    bits = torch.zeros((c, t), dtype=torch.int8, device=dev)
    valid = torch.zeros((c, t), dtype=torch.bool, device=dev)
    for i in range(t):
        sp = sp - 1.0
        has = sp < 1.0
        if not bool(has.any()):
            continue
        win = line[:, i + 1:i + 1 + w]                     # newest last
        votes = win[:, geom.vote_start:geom.vote_start + geom.vote_len]
        bit = votes.sum(1, dtype=torch.int32) > geom.vote_len // 2
        zc = win[:, w - zl:]
        crossings = (zc[:, :-1] != zc[:, 1:]).to(torch.int8)
        count = crossings.sum(1, dtype=torch.int32)
        first = torch.argmax(crossings, 1)
        err = (first.to(torch.float32) + 0.5) - k["zc_ideal"]
        if geom.two_crossings:
            last = zl - 2 - torch.argmax(crossings.flip(1), 1)
            err2 = (last.to(torch.float32) + 0.5) - k["zc_ideal"]
            err_two = torch.where(err.abs() < err2.abs(), err, err2)
            error = torch.where(count == 1, err,
                                torch.where(count == 2, err_two, zero))
        else:
            error = torch.where(count == 1, err, zero)
        # fma(error, gain, sp + sps): float64 product plus sum, rounded once
        sp_next = (error.double() * k["gain"]
                   + (sp + k["sps"]).double()).float()
        sp = torch.where(has, sp_next, sp)
        bits[:, i] = has & bit
        valid[:, i] = has
    return bits, valid, line[:, t:t + w].contiguous(), sp
