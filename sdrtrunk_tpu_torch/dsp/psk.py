"""DQPSK symbol recovery (port of sdrtrunk_tpu/dsp/psk.py).

Two per-sample feedback loops, each inherently sequential per channel:

* ``DQPSKDemodulator``, decision-directed (C4FM, DMR): Costas PLL mix,
  delay-line shift, one 8-tap polyphase interpolation, quadrant decision,
  timing and PLL updates. On the card it runs as the CUDA kernel of
  ``dsp/dqpsk_cuda.py``.
* ``GardnerDQPSKDemodulator``, Gardner-timed (LSM, P25 Phase 2): the same
  mix and PLL, but two interpolations per sample (the Gardner mid point at
  mu and the symbol point half a detected symbol period into the window),
  and a Gardner timing error detector. On the card it runs as the CUDA
  kernel of ``dsp/gardner_cuda.py``.

Each has a plain PyTorch version, ``scan_batched``: a Python loop over
samples, batched over channels. ``batched`` picks the path from where the
input lies: a CPU tensor runs the plain loop, any other tensor launches the
kernel or raises. There is no fallback from a kernel to its loop. Calling
a demodulator on one channel's 1-D block is ``batched`` at C = 1.

The plain loops are written in real arithmetic, one PyTorch op per
arithmetic step, in their kernel's order, so on the card each loop and its
kernel (built with ``--fmad=false``) agree bit for bit. Their rounding
follows the reference as XLA:CPU compiles it as closely as PyTorch can say
it: XLA contracts ``a * b + c`` into fused multiply-adds (the mix, the
8-tap sums, the differential decode, the Gardner error, the loop updates),
which the loops and the kernels take as a float64 product plus sum rounded
once to float32; and cos, sin and rsqrt are taken in float64 and rounded,
which lands nearer XLA's glibc ``cosf``/``sinf`` than float32 library
versions do. What still differs is an ulp now and then, which the loops
carry.

Dibit mapping (dsp/symbol/Dibit.java): 0=+1(+45deg) 1=+3(+135deg)
2=-1(-45deg) 3=-3(-135deg). Each sample emits one byte
``dibit | valid << 2``; bytes of samples with no symbol are 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .interpolator import CENTER, NSTEPS, NTAPS, interpolator_bank

from .. import resolve_device
from ..tree import per_channel

__all__ = ["DQPSKDemodulator", "DQPSKState", "GardnerDQPSKDemodulator",
           "GardnerState", "costas_gains"]

TWO_PI = 2.0 * math.pi
_SQRT_HALF = math.sqrt(0.5)


def _f32(v: float) -> float:
    """A Python float holding v rounded to float32 — the value the JAX
    reference's weakly typed constants take inside float32 ops."""
    return float(np.float32(v))


def costas_gains(loop_bandwidth: float = 300.0,
                 damping: float = math.sqrt(2.0) / 2.0) -> tuple[float, float]:
    """(alpha, beta) loop gains (CostasLoop.java:109-115)."""
    bw = TWO_PI / loop_bandwidth
    denom = 1.0 + 2.0 * damping * bw + bw * bw
    alpha = 4.0 * damping * bw / denom
    beta = 4.0 * bw * bw / denom
    return alpha, beta


class DQPSKState(NamedTuple):
    """Carried loop state; batched leaves carry a leading C axis."""
    window: torch.Tensor          # (C, W) complex64 delay line, newest last
    sampling_point: torch.Tensor  # (C,) float32
    detected_sps: torch.Tensor    # (C,) float32
    pll_phase: torch.Tensor       # (C,) float32
    pll_freq: torch.Tensor        # (C,) float32
    prev_preceding: torch.Tensor  # (C,) complex64
    prev_current: torch.Tensor    # (C,) complex64


class GardnerState(NamedTuple):
    """Carried Gardner loop state; batched leaves carry a leading C axis."""
    window: torch.Tensor           # (C, W) complex64 delay line, newest last
    sampling_point: torch.Tensor   # (C,) float32
    detected_sps: torch.Tensor     # (C,) float32
    pll_phase: torch.Tensor        # (C,) float32
    pll_freq: torch.Tensor         # (C,) float32
    prev_mid_sample: torch.Tensor  # (C,) complex64, raw mid point
    prev_cur_sample: torch.Tensor  # (C,) complex64, raw symbol point
    prev_cur_symbol: torch.Tensor  # (C,) complex64, normalized differential


def unpack_symbols(packed: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, C) uint8 ``dibit | valid << 2`` -> dibits (C, T) uint8 and
    valid (C, T) bool, as views in the reference's (C, T) layout."""
    return (packed & 3).T, (packed >= 4).T


class _Loop:
    """Per-call constants and the steps both plain loops share, each in
    its kernel's order (csrc/psk_common.cuh)."""

    def __init__(self, demod, x: torch.Tensor):
        self.k = demod.loop_constants()
        self.two_pi = _f32(TWO_PI)
        dev = x.device
        self.one = torch.ones((), dtype=torch.float32, device=dev)
        self.mone = -self.one
        self.zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.sign = torch.tensor([1.0, -1.0], dtype=torch.float64, device=dev)
        xv = torch.view_as_real(x.T.contiguous())                # (T, C, 2)
        self.x64 = xv.double().unbind(0)                         # [xr, xi]
        self.xs = (xv.flip(-1) * torch.tensor([-1.0, 1.0], device=dev)
                   ).unbind(0)                                   # [-xi, xr]

    def wrap(self, p: torch.Tensor) -> torch.Tensor:
        """CostasLoop phase wrap to +/-2pi, compared in float32."""
        p = torch.where(p > self.two_pi, p - self.two_pi, p)
        return torch.where(p < -self.two_pi, p + self.two_pi, p)

    def mix(self, i: int, phase: torch.Tensor) -> torch.Tensor:
        """Sample i de-rotated by the PLL phase (PSKDemodulator.java:
        101-110): [mr, mi] = fma([xr, xi], cos, [-(xi * sin), xr * sin])."""
        ph64 = phase.double()
        cos_p = torch.cos(ph64).float()
        sin_p = torch.sin(ph64).float()
        return (self.x64[i] * cos_p.double()[:, None]
                + (self.xs[i] * sin_p[:, None]).double()).float()

    @staticmethod
    def interp(taps64: torch.Tensor, w64: torch.Tensor) -> torch.Tensor:
        """8-tap sums over the tap axis -2 of the float64 products of
        float32 taps and samples: the first product rounded, then 7 fused
        multiply-adds left to right."""
        prod = (taps64[..., None] * w64).unbind(-2)
        acc = prod[0].float().double()
        for j in range(1, NTAPS - 1):
            acc = (prod[j] + acc).float().double()
        return (prod[NTAPS - 1] + acc).float()

    def diff_norm(self, pts: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        """normalize(p * conj(q)) over (..., 2) [re, im] float32 points:
        re = fma(p_re, q_re, p_im*q_im), im = fma(-p_re, q_im, p_im*q_re),
        then z * rsqrt(|z|^2) with the zero-safe guard."""
        pts64, prev64 = pts.double(), prev.double()
        t1 = pts64[..., :1] * prev64
        t2 = (pts64[..., 1:] * prev64).float()
        z = (t1 * self.sign + t2.flip(-1).double()).float()     # [re, im]
        sq = z.double() ** 2
        mag2 = (sq[..., 0] + sq[..., 1].float().double()).float()
        inv = torch.reciprocal(torch.sqrt(
            torch.clamp_min(mag2, 1e-30).double())).float()
        live = (mag2 > 1e-24)[..., None]
        return torch.where(live, z * inv[..., None], self.zero)

    def decide(self, cin: torch.Tensor, cqn: torch.Tensor):
        """Quadrant decision of the normalized symbol, its packed byte
        ``dibit | 4`` and the de-rotated quadrature error clipped to
        +/-0.3 with NaN zeroed (DQPSKDecisionDirectedSymbolEvaluator)."""
        i_pos, q_pos = cin > 0.0, cqn > 0.0
        byte = 6 - q_pos * 2 + ~i_pos          # dibit = 2 * !q_pos + !i_pos
        sgn_i = torch.where(i_pos, self.one, self.mone)
        sgn_q = torch.where(q_pos, self.one, self.mone)
        err = torch.clamp(_SQRT_HALF * (cqn * sgn_i - cin * sgn_q), -0.3, 0.3)
        return i_pos, byte, torch.nan_to_num(err, nan=0.0)

    def update(self, timing_error, err, sp1, dsps, fr, phase):
        """Timing and PLL updates (InterpolatingSampleBuffer.resetAndAdjust,
        CostasLoop.adjust); the frequency clamp follows the phase update
        that used the unclamped frequency. Returns (sampling point,
        detected sps, phase, freq) for channels with a symbol due."""
        k = self.k
        te64 = timing_error.double()
        detected = torch.clamp(
            (te64 * k["dsps_gain"] + dsps.double()).float(),
            k["sps_min"], k["sps_max"])
        sp_new = (te64 * k["g"] + (sp1 + detected).double()).float()
        perr64 = torch.clamp(-err, -0.5, 0.5).double()
        freq = (perr64 * k["beta"] + fr.double()).float()
        phase2 = self.wrap(
            (perr64 * k["alpha"] + (phase + freq).double()).float())
        freq = torch.clamp(freq, -k["max_pll_freq"], k["max_pll_freq"])
        return sp_new, detected, phase2, freq

    @staticmethod
    def packed(out: list, c: int, dev) -> torch.Tensor:
        """Per-sample bytes (None where no channel had a symbol) as (T, C)
        uint8."""
        if not out:
            return torch.zeros((0, c), dtype=torch.uint8, device=dev)
        blank = torch.zeros((c,), dtype=torch.int64, device=dev)
        return torch.stack([blank if o is None else o for o in out]
                           ).to(torch.uint8)


class _SymbolLoop(nn.Module):
    """Constants shared by both loops. The interpolator bank is a buffer,
    so ``.to(device)`` moves it."""

    def __init__(self, sample_rate: float, symbol_rate: float,
                 sample_counter_gain: float, loop_bandwidth: float,
                 max_deviation: float, device):
        super().__init__()
        self.sample_rate = sample_rate
        self.symbol_rate = symbol_rate
        self.sample_counter_gain = sample_counter_gain
        self.loop_bandwidth = loop_bandwidth
        self.max_deviation = max_deviation
        self.samples_per_symbol = sample_rate / symbol_rate
        if self.samples_per_symbol < 4.0:
            raise ValueError("need >= 4 samples/symbol for the 8-tap interpolator")
        self.alpha, self.beta = costas_gains(loop_bandwidth)
        self.max_pll_freq = TWO_PI * (symbol_rate / 2.0) / sample_rate
        self.dsps_gain = 0.1 * sample_counter_gain ** 2
        self.register_buffer("bank", torch.as_tensor(
            interpolator_bank(), device=resolve_device(device)))

    def loop_constants(self) -> dict[str, float]:
        """The loop's float32 constants, shared by the plain loop and the
        kernel (the reference applies them as float32 inside the loop)."""
        sps = self.samples_per_symbol
        return {
            "sps_min": _f32(sps * (1.0 - self.max_deviation)),
            "sps_max": _f32(sps * (1.0 + self.max_deviation)),
            "g": _f32(self.sample_counter_gain),
            "dsps_gain": _f32(self.dsps_gain),
            "alpha": _f32(self.alpha),
            "beta": _f32(self.beta),
            "max_pll_freq": _f32(self.max_pll_freq),
        }

    def _init(self, cls):
        """Fresh state of type cls for one channel (leaves without a
        channel axis): the nominal sampling point, zeros elsewhere."""
        dev = self.bank.device
        sps = torch.tensor(self.samples_per_symbol, dtype=torch.float32,
                           device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        czero = torch.zeros((), dtype=torch.complex64, device=dev)
        return cls(torch.zeros((self.window_len,), dtype=torch.complex64,
                               device=dev),
                   sps, sps.clone(), zero, zero.clone(),
                   *[czero.clone() for _ in cls._fields[5:]])

    def batched(self, x: torch.Tensor, state):
        """Demodulate a (C, T) complex64 block. Returns (dibits (C, T)
        uint8, valid (C, T) bool, new state). A CPU tensor runs the plain
        loop; any other tensor goes to the CUDA kernel, which launches or
        raises."""
        if x.device.type == "cpu":
            return self.scan_batched(x, state)
        packed, new_state = self._kernel(x, state)
        return (*unpack_symbols(packed), new_state)

    def forward(self, x: torch.Tensor, state=None):
        """Demodulate one channel's 1-D block (the reference's per-channel
        call): (dibits (T,) uint8, valid (T,) bool, new state), the state
        in ``init_state``'s layout, None for a fresh one. It is
        ``batched`` at C = 1: a CUDA tensor launches the kernel."""
        if state is None:
            state = self.init_state()
        return per_channel(self.batched, x, state)

    def scan_batched(self, x: torch.Tensor, state):
        """Plain PyTorch version of the kernel: a loop over samples."""
        packed, new_state = self.scan_packed(x, state)
        return (*unpack_symbols(packed), new_state)


class DQPSKDemodulator(_SymbolLoop):
    """Decision-directed DQPSK demod for constant-envelope 4-FSK (C4FM/DMR).

    sample_counter_gain: 0.3 for P25P1 (P25P1DecoderC4FM.java:48),
    0.4 for DMR (DMRDecoder.java:58).
    """

    def __init__(self, sample_rate: float, symbol_rate: float = 4800.0,
                 sample_counter_gain: float = 0.3,
                 loop_bandwidth: float = 300.0,
                 max_deviation: float = 0.02, device="cuda"):
        super().__init__(sample_rate, symbol_rate, sample_counter_gain,
                         loop_bandwidth, max_deviation, device)
        self.window_len = int(math.floor(2.0 * self.samples_per_symbol))

    def init_state(self) -> DQPSKState:
        """Fresh state for one channel (leaves without a channel axis)."""
        return self._init(DQPSKState)

    def _kernel(self, x, state):
        from .dqpsk_cuda import dqpsk_cuda
        return dqpsk_cuda(self, x, state)

    def scan_packed(self, x: torch.Tensor, state: DQPSKState
                    ) -> tuple[torch.Tensor, DQPSKState]:
        """The plain loop with the kernel's output: (T, C) uint8
        ``dibit | valid << 2`` and the new state.

        A fused multiply-add fma(a, b, c) is taken as the float64 product
        of float32 a and b (exact) plus c, rounded once to float32. To keep
        the op count per sample low, the delay line is a Python list of
        (C, 2) [re, im] samples (a shift costs nothing), the preceding and
        current points are decoded together as (C, 2, 2) tensors, and a
        sample on which no channel has a symbol due skips the symbol
        update, which would leave every channel's state as it is."""
        lp = _Loop(self, x)
        c, t = x.shape
        bank64 = self.bank.double()
        win = list(torch.view_as_real(state.window).unbind(1))  # W x (C, 2)
        sp, dsps = state.sampling_point, state.detected_sps
        ph, fr = state.pll_phase, state.pll_freq
        # [preceding, current] x [re, im] of the last symbol
        prev = torch.stack([torch.view_as_real(state.prev_preceding),
                            torch.view_as_real(state.prev_current)], 1)
        out = []
        for i in range(t):
            phase = lp.wrap(ph + fr)
            win = win[1:] + [lp.mix(i, phase)]
            sp1 = sp - 1.0
            has = sp1 < 1.0
            if not bool(has.any()):
                sp, ph = sp1, phase
                out.append(None)
                continue

            # --- interpolate at mu: arm by index ---
            mu = torch.clamp(sp1, 0.0, 1.0)
            idx = (mu * float(NSTEPS)).long().clamp_(0, NSTEPS)
            cur = lp.interp(bank64[idx],
                            torch.stack(win[:NTAPS], 1).double())

            # --- differential decode + normalize, both points at once ---
            pts = torch.stack([win[CENTER], cur], 1)          # (C, 2, 2)
            zn = lp.diff_norm(pts, prev)
            pqn, cin, cqn = zn[:, 0, 1], zn[:, 1, 0], zn[:, 1, 1]

            i_pos, byte, err = lp.decide(cin, cqn)
            out.append(has * byte)
            polarity = torch.where(torch.where(i_pos, pqn > cqn, pqn < cqn),
                                   lp.one, lp.mone)
            sp_new, detected, phase2, freq = lp.update(
                err * polarity, err, sp1, dsps, fr, phase)

            sp = torch.where(has, sp_new, sp1)
            dsps = torch.where(has, detected, dsps)
            ph = torch.where(has, phase2, phase)
            fr = torch.where(has, freq, fr)
            prev = torch.where(has[:, None, None], pts, prev)
        new_state = DQPSKState(
            window=torch.view_as_complex(torch.stack(win, 1)),
            sampling_point=sp, detected_sps=dsps, pll_phase=ph, pll_freq=fr,
            prev_preceding=torch.view_as_complex(prev[:, 0].contiguous()),
            prev_current=torch.view_as_complex(prev[:, 1].contiguous()))
        return lp.packed(out, c, x.device), new_state


class GardnerDQPSKDemodulator(_SymbolLoop):
    """DQPSK demod with a Gardner timing error detector, for P25 LSM and
    P25 Phase 2 HDQPSK (DQPSKGardnerDemodulator.java:30-88,
    DQPSKGardnerSymbolEvaluator.java:63-106).

    Two interpolation points per symbol: the mid point at the sampling
    point mu, and the symbol point at detected_sps / 2 into the window.
    Each point's integer offset selects the 8-tap base in the delay line,
    its fraction the polyphase arm. The base is read only where it lies in
    the point's statically feasible set (``mid_bases``, ``cur_bases``, as
    the reference restricts it) and the point is 0 otherwise. Both points
    are differentially decoded against their own previous raw samples and
    normalized; the Gardner error (prev - cur) . mid, clipped to +/-0.3,
    drives timing, and the quadrant decision's de-rotated quadrature drives
    the PLL.
    """

    def __init__(self, sample_rate: float, symbol_rate: float = 4800.0,
                 sample_counter_gain: float = 0.3,
                 loop_bandwidth: float = 300.0,
                 max_deviation: float = 0.02, device="cuda"):
        super().__init__(sample_rate, symbol_rate, sample_counter_gain,
                         loop_bandwidth, max_deviation, device)
        sps = self.samples_per_symbol
        # the window covers the symbol point's offset floor(sps_max/2)
        # plus the 8 interpolator taps (psk.py:379-382)
        self.window_len = w = max(int(math.floor(2.0 * sps)),
                                  int(sps * 1.02 / 2) + 9)
        sps_min = sps * (1.0 - max_deviation)
        sps_max = sps * (1.0 + max_deviation)
        self.mid_bases = tuple(range(0, min(w - 8, 1) + 1))
        lo = max(0, int(math.floor(sps_min / 2.0)) - 1)
        hi = min(w - 8, int(math.floor(sps_max / 2.0)) + 1)
        self.cur_bases = tuple(range(lo, hi + 1))

    def base_ranges(self) -> tuple[int, int, int, int]:
        """(mid_lo, mid_hi, cur_lo, cur_hi): the two base sets, each a
        contiguous range."""
        return (self.mid_bases[0], self.mid_bases[-1],
                self.cur_bases[0], self.cur_bases[-1])

    def init_state(self) -> GardnerState:
        """Fresh state for one channel (leaves without a channel axis)."""
        return self._init(GardnerState)

    def _kernel(self, x, state):
        from .gardner_cuda import gardner_cuda
        return gardner_cuda(self, x, state)

    def scan_packed(self, x: torch.Tensor, state: GardnerState
                    ) -> tuple[torch.Tensor, GardnerState]:
        """The plain loop with the kernel's output: (T, C) uint8
        ``dibit | valid << 2`` and the new state.

        As in ``DQPSKDemodulator.scan_packed``, the delay line is a list
        of (C, 2) samples and a sample with no symbol due on any channel
        skips the symbol step. The two points travel together as (C, 2)
        [mid, cur] tensors: offsets, bases, arms, the window fetch (a
        gather at base + 0..7, kept only where the base is in its set) and
        the differential decode."""
        lp = _Loop(self, x)
        c, t = x.shape
        w = self.window_len
        dev = x.device
        bank64 = self.bank.double()
        mid_lo, mid_hi, cur_lo, cur_hi = self.base_ranges()
        lo = torch.tensor([mid_lo, cur_lo], device=dev)
        hi = torch.tensor([mid_hi, cur_hi], device=dev)
        taps_at = torch.arange(NTAPS, device=dev)
        win = list(torch.view_as_real(state.window).unbind(1))  # W x (C, 2)
        sp, dsps = state.sampling_point, state.detected_sps
        ph, fr = state.pll_phase, state.pll_freq
        # raw [mid, cur] samples and the last symbol, [re, im]
        prev = torch.stack([torch.view_as_real(state.prev_mid_sample),
                            torch.view_as_real(state.prev_cur_sample)], 1)
        prev_sym = torch.view_as_real(state.prev_cur_symbol)
        out = []
        for i in range(t):
            phase = lp.wrap(ph + fr)
            win = win[1:] + [lp.mix(i, phase)]
            sp1 = sp - 1.0
            has = sp1 < 1.0
            if not bool(has.any()):
                sp, ph = sp1, phase
                out.append(None)
                continue

            # --- the two points: integer base + arm, then 8 taps ---
            off = torch.stack([torch.clamp(sp1, 0.0, 1.0), dsps * 0.5], 1)
            k = torch.floor(off)
            arm = ((off - k) * float(NSTEPS)).long().clamp_(0, NSTEPS)
            base = k.long().clamp_(0, w - 8)                    # (C, 2)
            fetch = (base[..., None] + taps_at).reshape(c, 2 * NTAPS, 1)
            w8 = torch.stack(win, 1).double().gather(
                1, fetch.expand(c, 2 * NTAPS, 2)).reshape(c, 2, NTAPS, 2)
            inset = ((base >= lo) & (base <= hi))[..., None]
            pts = torch.where(inset, lp.interp(bank64[arm], w8), lp.zero)
            zn = lp.diff_norm(pts, prev)                        # [mid, cur]
            ms, cs = zn[:, 0], zn[:, 1]

            # --- Gardner TED: fma(d_re, m_re, d_im * m_im), d = prev - cur
            d64 = (prev_sym - cs).double()
            m64 = ms.double()
            terr = (d64[:, 0] * m64[:, 0]
                    + (d64[:, 1] * m64[:, 1]).float().double()).float()
            terr = torch.clamp(torch.nan_to_num(terr, nan=0.0), -0.3, 0.3)

            _, byte, err = lp.decide(cs[:, 0], cs[:, 1])
            out.append(has * byte)
            sp_new, detected, phase2, freq = lp.update(
                terr, err, sp1, dsps, fr, phase)

            sp = torch.where(has, sp_new, sp1)
            dsps = torch.where(has, detected, dsps)
            ph = torch.where(has, phase2, phase)
            fr = torch.where(has, freq, fr)
            prev = torch.where(has[:, None, None], pts, prev)
            prev_sym = torch.where(has[:, None], cs, prev_sym)
        new_state = GardnerState(
            window=torch.view_as_complex(torch.stack(win, 1)),
            sampling_point=sp, detected_sps=dsps, pll_phase=ph, pll_freq=fr,
            prev_mid_sample=torch.view_as_complex(prev[:, 0].contiguous()),
            prev_cur_sample=torch.view_as_complex(prev[:, 1].contiguous()),
            prev_cur_symbol=torch.view_as_complex(prev_sym.contiguous()))
        return lp.packed(out, c, dev), new_state
