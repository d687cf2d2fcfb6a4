"""The plain reference's building blocks: filter designs in NumPy float64
and the vectorised stages in PyTorch, written from the published
algorithms and independent of the program under test.

Every stage takes a ``Precision``: the reference runs in float64; the
control (``Precision.tf32()``) runs in float32 with the operands of every
filter product rounded to TF32 (10 mantissa bits), which is what the
program computes once TF32 is switched on for its convolutions and
matmuls. Sequential loops (the DQPSK symbol loop) live in ``c4fm.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

TWO_PI = 2.0 * math.pi
TINY = 1e-30                     # the least scale a gap is taken over


@dataclass(frozen=True)
class Precision:
    """The arithmetic a reference run uses: real dtype and whether filter
    operands are rounded to TF32."""
    real: torch.dtype = torch.float64
    tf32: bool = False

    @property
    def complex(self) -> torch.dtype:
        return torch.complex128 if self.real == torch.float64 \
            else torch.complex64

    @property
    def np_real(self):
        return np.float64 if self.real == torch.float64 else np.float32

    @classmethod
    def tf32_control(cls) -> "Precision":
        return cls(torch.float32, True)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A filter operand as the product sees it."""
        return round_tf32(t) if self.tf32 else t


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values (or each plane of complex64) to TF32's 10
    mantissa bits, nearest, ties away from zero (the tensor cores'
    conversion)."""
    if t.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(t)))
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


# --------------------------------------------------------------- designs

def kaiser_beta(attenuation_db: float) -> float:
    a = float(attenuation_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_window(length: int, attenuation_db: float) -> np.ndarray:
    beta = kaiser_beta(attenuation_db)
    n = np.arange(length, dtype=np.float64)
    m = length - 1.0
    return np.i0(beta * np.sqrt(1.0 - ((2.0 * n - m) / m) ** 2)) / np.i0(beta)


def kaiser_sinc(length: int, cutoff: float,
                attenuation_db: float = 80.0) -> np.ndarray:
    """Odd-length Kaiser-windowed sinc low-pass, cutoff in cycles a
    sample."""
    n = np.arange(length, dtype=np.float64) - length // 2
    return 2.0 * cutoff * np.sinc(2.0 * cutoff * n) \
        * kaiser_window(length, attenuation_db)


def response_db(taps: np.ndarray, frequency: float) -> float:
    """|H|^2 in dB at ``frequency`` in units of half the sample rate."""
    n = np.arange(len(taps), dtype=np.float64)
    z = np.sum(taps * np.exp(1j * np.pi * frequency * n))
    return float(10.0 * np.log10(z.real ** 2 + z.imag ** 2))


def channelizer_prototype(channels: int, taps_per_branch: int = 9
                          ) -> np.ndarray:
    """The M/2 polyphase channelizer's prototype low-pass: a Kaiser sinc
    of M * taps - 1 taps whose response at the channel edge (1/M of half
    the rate) is -6.02 dB within 0.0003 dB (adjacent channels sum flat),
    at the highest cutoff that holds it, found by a halving search from
    half the edge (sdrtrunk's FilterFactory.getSincM2Channelizer); one
    zero in front makes M * taps. The search widens the filter a tap a
    branch at a time if it fails."""
    target = 20.0 * np.log10(0.5)

    def ok(r: float) -> bool:
        return abs(r - target) <= 0.0003

    edge = 1.0 / channels
    resolution = 1.0 / (12500.0 * channels)
    for taps_per in range(taps_per_branch, taps_per_branch + 11):
        length = channels * taps_per - 1
        cutoff = edge / 2.0
        step = cutoff * 0.1
        taps = kaiser_sinc(length, cutoff)
        r = response_db(taps, edge)
        failed = False
        while step > resolution:
            if ok(r) and cutoff + step <= edge:
                wider = kaiser_sinc(length, cutoff + step)
                rw = response_db(wider, edge)
                if ok(rw):
                    cutoff += step
                    taps, r = wider, rw
                else:
                    step /= 2.0
            elif ok(r):
                step /= 2.0
            else:
                cutoff -= step
                if cutoff <= 0:
                    failed = True
                    break
                taps = kaiser_sinc(length, cutoff)
                r = response_db(taps, edge)
        if not failed and ok(r):
            return np.concatenate([[0.0], taps])
    raise ValueError(f"no channelizer prototype for {channels} channels")


def remez_lowpass(num_taps: int, pass_hz: float, stop_hz: float,
                  sample_rate: float, pass_ripple: float = 0.01,
                  stop_ripple: float = 0.01) -> np.ndarray:
    """Equiripple low-pass (Parks-McClellan), odd length."""
    from scipy import signal

    num_taps |= 1
    return np.asarray(signal.remez(
        num_taps, [0.0, pass_hz, stop_hz, sample_rate / 2.0], [1.0, 0.0],
        weight=[1.0 / pass_ripple, 1.0 / stop_ripple], fs=sample_rate),
        np.float64)


def interpolator_bank(steps: int = 128, taps: int = 8,
                      center: int = 3) -> np.ndarray:
    """(steps + 1, taps) fractional-delay bank, float32: row i
    interpolates CENTER + i / steps samples into an 8-sample window, a
    Blackman-windowed sinc normalised to unit DC gain."""
    bank = np.zeros((steps + 1, taps))
    j = np.arange(taps, dtype=np.float64)
    for i in range(steps + 1):
        t = j - (center + i / steps)
        w = (0.42 + 0.5 * np.cos(np.pi * t / (taps / 2.0))
             + 0.08 * np.cos(2.0 * np.pi * t / (taps / 2.0)))
        h = np.sinc(t) * np.where(np.abs(t) <= taps / 2.0, w, 0.0)
        bank[i] = h / np.sum(h)
    return bank.astype(np.float32)


def resample_taps(up: int, down: int, taps_per_phase: int = 12,
                  attenuation_db: float = 80.0) -> np.ndarray:
    """Polyphase resampler prototype, zero-padded to a multiple of up."""
    length = (up * taps_per_phase) | 1
    taps = kaiser_sinc(length, 0.5 / max(up, down), attenuation_db) * up
    return np.concatenate([taps, np.zeros((-len(taps)) % up)])


# --------------------------------------------------------------- stages
# Each stage runs over a chunk from the state the stage carries (the
# leaves of ``check.FRONT`` and of each chain's ``STATE``), given as NumPy
# arrays: history samples oldest first, a one-pole filter's last output.

def ingest(chunk: np.ndarray, p: Precision, device) -> torch.Tensor:
    """int8 (n, 2) I/Q pairs -> complex samples scaled by 1/127."""
    x = torch.as_tensor(chunk, device=device).to(p.real)
    return torch.complex(x[:, 0], x[:, 1]) / 127.0


def channelize_bins(x: torch.Tensor, history: np.ndarray, hmat: np.ndarray,
                    bins, p: Precision) -> torch.Tensor:
    """M/2 polyphase analysis of x behind T M history samples, at the bins
    asked for: y[k, m] = (-1)^(m k) sum_r u[k, r] e^(2 pi i r m / M) with
    u[k, r] = sum_q h[q M + r] x[k M/2 - q M - r]. Returns (len(bins), K)
    streams at twice the channel spacing."""
    t, m = hmat.shape
    dev = x.device
    k = 2 * x.shape[0] // m
    xp = torch.cat([torch.as_tensor(history, device=dev).to(x.dtype), x])
    base = (t * m + torch.arange(k, device=dev) * (m // 2))[:, None] \
        - torch.arange(m, device=dev)[None, :]
    h = torch.as_tensor(hmat, device=dev).to(p.real)
    u = torch.zeros((k, m), dtype=p.complex, device=dev)
    for q in range(t):
        u = u + h[q][None, :] * xp[base - q * m]
    sel = torch.as_tensor(np.asarray(bins), device=dev)
    y = torch.fft.ifft(u, dim=1)[:, sel] * m
    sign = 1 - 2 * ((torch.arange(k, device=dev)[:, None] * sel[None, :]) & 1)
    return (y * sign).T.contiguous()


# e^(-i pi j / 2), j = 0..3
QUARTER_TURNS = (1 + 0j, -1j, -1 + 0j, 1j)


def join_pair(lo: torch.Tensor, hi: torch.Tensor, rot: int) -> torch.Tensor:
    """Two adjacent bins' (C, K) streams joined into one wide stream
    centred midway between them, the role of sdrtrunk's
    TwoChannelSynthesizerM2 behind an M/2 channelizer whose bin m sits at
    +m fs / M. In closed form (no synthesis filter: the prototype's
    half-amplitude band edge makes the joint response flat),
    z[n] = e^(-i pi (rot + n) / 2) lo[n] - e^(+i pi (rot + n) / 2) hi[n]:
    the lower bin moved down, the upper up, by a quarter of the channel
    rate, the cycle taken on from ``rot`` (the port states the same form
    in ``sdrtrunk_tpu_torch/dsp/synthesizer.py:5-13``)."""
    n = torch.arange(lo.shape[-1], device=lo.device)
    turn = torch.tensor(QUARTER_TURNS, dtype=lo.dtype,
                        device=lo.device)[(int(rot) + n) % 4]
    return turn * lo - turn.conj() * hi


def mix(streams: torch.Tensor, step_rad, phase0) -> tuple:
    """Each row turned by -(phase0 + step n) (the slot's residual offset
    from its bin). Returns (rows, the phase after the chunk mod 2 pi)."""
    dev = streams.device
    step = torch.as_tensor(np.asarray(step_rad, np.float64), device=dev)
    ph0 = torch.as_tensor(np.asarray(phase0, np.float64), device=dev)
    k = streams.shape[1]
    n = torch.arange(k, device=dev, dtype=torch.float64)
    ang = ph0[:, None] + step[:, None] * n[None, :]
    rows = streams * torch.polar(torch.ones_like(ang), -ang).to(streams.dtype)
    return rows, np.remainder((ph0 + step * k).cpu().numpy(), TWO_PI)


def fir(x: torch.Tensor, taps: np.ndarray, history: np.ndarray,
        p: Precision) -> torch.Tensor:
    """y[c, n] = sum_k taps[k] x[c, n - k], x[c, -j] from ``history``
    (C, len(taps) - 1), over real or complex (C, T) rows."""
    h = p.operand(torch.as_tensor(taps, device=x.device).to(p.real))
    xp = torch.cat([torch.as_tensor(history, device=x.device).to(x.dtype), x],
                   dim=1)
    planes = torch.view_as_real(xp).permute(0, 2, 1) if x.is_complex() \
        else xp[:, None, :]
    c, k, n = planes.shape
    y = F.conv1d(p.operand(planes.reshape(c * k, 1, n)),
                 h.flip(0)[None, None, :]).reshape(c, k, -1)
    if x.is_complex():
        return torch.view_as_complex(y.permute(0, 2, 1).contiguous())
    return y[:, 0]


def agc(x: torch.Tensor, history: np.ndarray, window: int = 32):
    """x over the largest envelope of its last ``window`` samples
    (``history`` the window - 1 envelopes before), floored at 1e-4.
    Returns (leveled rows, the new envelope history)."""
    env = torch.cat([torch.as_tensor(history, device=x.device).to(x.real.dtype),
                     torch.abs(x)], dim=1)
    peak = F.max_pool1d(env[:, None, :], window, stride=1)[:, 0]
    return x / torch.clamp_min(peak, 1e-4), env[:, -(window - 1):]


def one_pole(x: np.ndarray, alpha: float, y0: np.ndarray,
             p: Precision) -> np.ndarray:
    """y[t] = (1 - alpha) y[t - 1] + alpha x[t] from y[-1] = y0, along the
    last axis. The control's TF32 rounds the input and its gain, the
    operands a TF32 matmul of the filter's closed form would round on the
    input side; the pole stays as it is."""
    from scipy import signal

    x = np.asarray(x, p.np_real)
    a, b = 1.0 - alpha, alpha
    if p.tf32:
        x = round_tf32(torch.as_tensor(x)).numpy()
        b = float(round_tf32(torch.tensor([b], dtype=torch.float32))[0])
    zi = (a * np.asarray(y0, np.float64))[:, None]
    y, _ = signal.lfilter([b], [1.0, -a], x, axis=-1, zi=zi)
    return y.astype(p.np_real)


def resample(x: torch.Tensor, taps: np.ndarray, up: int, down: int,
             history: np.ndarray, p: Precision) -> torch.Tensor:
    """Rational resampling by up / down behind ``history`` (C, len(taps) /
    up): y[m] = sum_j taps[j up + (m down) % up] x[(m down) // up - j]."""
    tpp = len(taps) // up
    n_out = x.shape[1] * up // down
    mm = np.arange(n_out)
    phase, base = (mm * down) % up, (mm * down) // up
    j = np.arange(tpp)
    idx = torch.as_tensor(tpp + base[:, None] - j[None, :], device=x.device)
    coef = torch.as_tensor(np.asarray(taps)[j[None, :] * up + phase[:, None]],
                           device=x.device).to(p.real)
    xp = torch.cat([torch.as_tensor(history, device=x.device).to(x.dtype),
                    p.operand(x)], dim=1)
    return (xp[:, idx] * p.operand(coef)[None]).sum(-1)
