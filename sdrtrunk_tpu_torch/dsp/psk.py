"""Decision-directed DQPSK symbol recovery (port of sdrtrunk_tpu/dsp/psk.py).

The per-sample feedback loop — Costas PLL mix, delay-line shift, 8-tap
polyphase interpolation, quadrant decision, timing and PLL updates — is
inherently sequential per channel. On the card it runs as the CUDA kernel
of ``dsp/dqpsk_cuda.py`` (one thread per channel); ``scan_batched`` is its
plain PyTorch version: a Python loop over samples, batched over channels.

``batched`` picks the path from where the input lies: a CPU tensor runs
the plain loop, any other tensor launches the kernel or raises. There is
no fallback from the kernel to the loop.

The plain loop is written in real arithmetic, one PyTorch op per
arithmetic step, in the kernel's order, so on the card the loop and the
kernel (built with ``--fmad=false``) agree bit for bit. Its rounding
follows the reference as XLA:CPU compiles it as closely as PyTorch can
say it: XLA contracts ``a * b + c`` into fused multiply-adds (the mix,
the 8-tap sum, the differential decode, the loop updates), which the
loop and the kernel take as a float64 product plus sum rounded once to
float32; and cos, sin and rsqrt are taken in float64 and rounded, which
lands nearer XLA's glibc ``cosf``/``sinf`` than float32 library versions
do. What still differs is an ulp now and then, which the loop carries.

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

from sdrtrunk_tpu.dsp.interpolator import CENTER, NSTEPS, NTAPS, interpolator_bank

from .. import resolve_device

__all__ = ["DQPSKDemodulator", "DQPSKState", "costas_gains"]

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


def unpack_symbols(packed: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, C) uint8 ``dibit | valid << 2`` -> dibits (C, T) uint8 and
    valid (C, T) bool, as views in the reference's (C, T) layout."""
    return (packed & 3).T, (packed >= 4).T


class DQPSKDemodulator(nn.Module):
    """Decision-directed DQPSK demod for constant-envelope 4-FSK (C4FM/DMR).

    sample_counter_gain: 0.3 for P25P1 (P25P1DecoderC4FM.java:48),
    0.4 for DMR (DMRDecoder.java:58). The interpolator bank is a buffer,
    so ``.to(device)`` moves it.
    """

    def __init__(self, sample_rate: float, symbol_rate: float = 4800.0,
                 sample_counter_gain: float = 0.3,
                 loop_bandwidth: float = 300.0,
                 max_deviation: float = 0.02, device="cuda"):
        super().__init__()
        self.sample_rate = sample_rate
        self.symbol_rate = symbol_rate
        self.sample_counter_gain = sample_counter_gain
        self.loop_bandwidth = loop_bandwidth
        self.max_deviation = max_deviation
        self.samples_per_symbol = sample_rate / symbol_rate
        if self.samples_per_symbol < 4.0:
            raise ValueError("need >= 4 samples/symbol for the 8-tap interpolator")
        self.window_len = int(math.floor(2.0 * self.samples_per_symbol))
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

    def init_state(self) -> DQPSKState:
        """Fresh state for one channel (leaves without a channel axis)."""
        dev = self.bank.device
        sps = torch.tensor(self.samples_per_symbol, dtype=torch.float32,
                           device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        czero = torch.zeros((), dtype=torch.complex64, device=dev)
        return DQPSKState(
            window=torch.zeros((self.window_len,), dtype=torch.complex64,
                               device=dev),
            sampling_point=sps, detected_sps=sps.clone(),
            pll_phase=zero, pll_freq=zero.clone(),
            prev_preceding=czero, prev_current=czero.clone())

    def batched(self, x: torch.Tensor, state: DQPSKState
                ) -> tuple[torch.Tensor, torch.Tensor, DQPSKState]:
        """Demodulate a (C, T) complex64 block. Returns (dibits (C, T)
        uint8, valid (C, T) bool, new state). A CPU tensor runs the plain
        loop; any other tensor goes to the CUDA kernel, which launches or
        raises."""
        if x.device.type == "cpu":
            return self.scan_batched(x, state)
        from .dqpsk_cuda import dqpsk_cuda
        packed, new_state = dqpsk_cuda(self, x, state)
        return (*unpack_symbols(packed), new_state)

    def scan_batched(self, x: torch.Tensor, state: DQPSKState
                     ) -> tuple[torch.Tensor, torch.Tensor, DQPSKState]:
        """Plain PyTorch version of the kernel: a loop over samples."""
        packed, new_state = self.scan_packed(x, state)
        return (*unpack_symbols(packed), new_state)

    def scan_packed(self, x: torch.Tensor, state: DQPSKState
                    ) -> tuple[torch.Tensor, DQPSKState]:
        """The plain loop with the kernel's output: (T, C) uint8
        ``dibit | valid << 2`` and the new state.

        A fused multiply-add fma(a, b, c) is taken as the float64 product
        of float32 a and b (exact) plus c, rounded once to float32, so
        values that enter products are kept beside their float32 selves
        in float64. To keep the op count per sample low, the delay line is
        a Python list of (C, 2) [re, im] samples (a shift costs nothing),
        the preceding and current points are decoded together as (C, 2, 2)
        tensors, and a sample on which no channel has a symbol due skips
        the symbol update, which would leave every channel's state as it
        is."""
        k = self.loop_constants()
        two_pi = _f32(TWO_PI)
        c, t = x.shape
        dev = x.device
        f64 = torch.float64
        one = torch.ones((), dtype=torch.float32, device=dev)
        mone, zero = -one, torch.zeros((), dtype=torch.float32, device=dev)
        sign = torch.tensor([1.0, -1.0], dtype=f64, device=dev)
        bank64 = self.bank.double()
        xv = torch.view_as_real(x.T.contiguous())                # (T, C, 2)
        x64 = xv.double().unbind(0)                              # [xr, xi]
        xs = (xv.flip(-1) * torch.tensor([-1.0, 1.0], device=dev)
              ).unbind(0)                                        # [-xi, xr]
        win = list(torch.view_as_real(state.window).unbind(1))  # W x (C, 2)
        win64 = [w.double() for w in win]
        sp, dsps = state.sampling_point, state.detected_sps
        ph, fr = state.pll_phase, state.pll_freq
        # [preceding, current] x [re, im] of the last symbol
        prev = torch.stack([torch.view_as_real(state.prev_preceding),
                            torch.view_as_real(state.prev_current)], 1)
        prev64 = prev.double()
        out = []
        for i in range(t):
            # --- PLL increment + mix (PSKDemodulator.java:101-110) ---
            phase = ph + fr
            phase = torch.where(phase > two_pi, phase - two_pi, phase)
            phase = torch.where(phase < -two_pi, phase + two_pi, phase)
            ph64 = phase.double()
            cos_p = torch.cos(ph64).float()
            sin_p = torch.sin(ph64).float()
            # [mr, mi] = fma([xr, xi], cos, [-(xi * sin), xr * sin])
            mixed = (x64[i] * cos_p.double()[:, None]
                     + (xs[i] * sin_p[:, None]).double()).float()
            win = win[1:] + [mixed]
            win64 = win64[1:] + [mixed.double()]
            sp1 = sp - 1.0
            has = sp1 < 1.0
            if not bool(has.any()):
                sp, ph = sp1, phase
                out.append(None)
                continue

            # --- interpolate at mu: arm by index, then 8 fused
            # multiply-adds left to right ---
            mu = torch.clamp(sp1, 0.0, 1.0)
            idx = (mu * float(NSTEPS)).long().clamp_(0, NSTEPS)
            prod = (bank64[idx][:, :, None]
                    * torch.stack(win64[:NTAPS], 1)).unbind(1)
            cur64 = prod[0].float().double()
            for j in range(1, NTAPS - 1):
                cur64 = (prod[j] + cur64).float().double()
            cur = (prod[NTAPS - 1] + cur64).float()

            # --- differential decode + normalize, both points at once:
            # re = fma(p_re, q_re, p_im*q_im), im = fma(-p_re, q_im, p_im*q_re)
            pts = torch.stack([win[CENTER], cur], 1)          # (C, 2, 2)
            pts64 = torch.stack([win64[CENTER], cur.double()], 1)
            t1 = pts64[..., :1] * prev64
            t2 = (pts64[..., 1:] * prev64).float()
            z = (t1 * sign + t2.flip(-1).double()).float()    # [re, im]
            sq = z.double() ** 2
            mag2 = (sq[..., 0] + sq[..., 1].float().double()).float()
            inv = torch.reciprocal(torch.sqrt(
                torch.clamp_min(mag2, 1e-30).double())).float()
            live = (mag2 > 1e-24)[..., None]
            zn = torch.where(live, z * inv[..., None], zero)
            pqn, cin, cqn = zn[:, 0, 1], zn[:, 1, 0], zn[:, 1, 1]

            # --- quadrant decision + errors (DQPSKDecisionDirectedSymbolEvaluator)
            i_pos, q_pos = cin > 0.0, cqn > 0.0
            # has * (dibit | 4) with dibit = 2 * !q_pos + !i_pos
            out.append(has * (6 - q_pos * 2 + ~i_pos))
            polarity = torch.where(torch.where(i_pos, pqn > cqn, pqn < cqn),
                                   one, mone)
            sgn_i = torch.where(i_pos, one, mone)
            sgn_q = torch.where(q_pos, one, mone)
            err = torch.clamp(_SQRT_HALF * (cqn * sgn_i - cin * sgn_q),
                              -0.3, 0.3)
            err = torch.nan_to_num(err, nan=0.0)
            timing_error = err * polarity

            # --- timing + PLL updates (resetAndAdjust / CostasLoop.adjust)
            te64 = timing_error.double()
            detected = torch.clamp(
                (te64 * k["dsps_gain"] + dsps.double()).float(),
                k["sps_min"], k["sps_max"])
            sp_new = (te64 * k["g"] + (sp1 + detected).double()).float()
            perr = torch.clamp(-err, -0.5, 0.5)
            perr64 = perr.double()
            freq = (perr64 * k["beta"] + fr.double()).float()
            phase2 = (perr64 * k["alpha"] + (phase + freq).double()).float()
            phase2 = torch.where(phase2 > two_pi, phase2 - two_pi, phase2)
            phase2 = torch.where(phase2 < -two_pi, phase2 + two_pi, phase2)
            freq = torch.clamp(freq, -k["max_pll_freq"], k["max_pll_freq"])

            sp = torch.where(has, sp_new, sp1)
            dsps = torch.where(has, detected, dsps)
            ph = torch.where(has, phase2, phase)
            fr = torch.where(has, freq, fr)
            has3 = has[:, None, None]
            prev = torch.where(has3, pts, prev)
            prev64 = torch.where(has3, pts64, prev64)
        blank = torch.zeros((c,), dtype=torch.int64, device=dev)
        packed = torch.stack([blank if o is None else o for o in out]
                             ).to(torch.uint8) if out else \
            torch.zeros((0, c), dtype=torch.uint8, device=dev)
        new_state = DQPSKState(
            window=torch.view_as_complex(torch.stack(win, 1)),
            sampling_point=sp, detected_sps=dsps, pll_phase=ph, pll_freq=fr,
            prev_preceding=torch.view_as_complex(prev[:, 0].contiguous()),
            prev_current=torch.view_as_complex(prev[:, 1].contiguous()))
        return packed, new_state
