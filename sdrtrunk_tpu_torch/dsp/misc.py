"""Miscellaneous filters: Goertzel tone power, IIR biquad, CMA equalizer,
IQ DC correction, Hilbert real -> complex transform (port of
sdrtrunk_tpu/dsp/misc.py).

The reference's one-off filters (dsp/filter/GoertzelFilter.java:31,
dsp/filter/iir/IIRBiQuadraticFilter.java:43,
dsp/filter/equalizer/CMAEqualizer.java:8,
dsp/filter/correction/IQCorrectionFilter.java:24,
dsp/filter/hilbert/HilbertTransform.java:25). The block-parallel ones
(Goertzel, Hilbert, the IQ correction's single poles) are batched tensor
expressions. The two per-sample feedback loops, the biquad and the CMA
equalizer (each a ``lax.scan`` in the JAX package), pick the path from
where the input lies: a CPU tensor runs the plain version here
(``biquad_apply_plain``, ``cma_equalize_plain``, Python loops over
samples), any other tensor launches the CUDA kernel
(``dsp/biquad_cuda.py``, ``dsp/cma_cuda.py``) or raises; there is no
fallback from the kernel to the loop. ``biquad_design`` and
``hilbert_taps`` are host NumPy.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .iir import single_pole

__all__ = [
    "goertzel_power", "goertzel_magnitude",
    "biquad_design", "biquad_apply", "biquad_apply_plain", "biquad_init",
    "cma_equalize", "cma_equalize_plain", "cma_init",
    "iq_correction",
    "hilbert_taps", "real_to_complex",
]


# ---------------------------------------------------------------------------
# Goertzel tone detection
# ---------------------------------------------------------------------------

def goertzel_power(x: torch.Tensor, frequency: float, sample_rate: float
                   ) -> torch.Tensor:
    """Signal power at `frequency` over the block (GoertzelFilter.getPower),
    as the single-bin DFT: the inner product with the complex exponential.
    Accepts x of shape (..., N); reduces the last axis."""
    n = x.shape[-1]
    w = 2.0 * math.pi * frequency / sample_rate
    angles = w * torch.arange(n, dtype=torch.float32, device=x.device)
    probe = torch.complex(torch.cos(angles), -torch.sin(angles))
    bin_val = torch.sum(x.to(torch.complex64) * probe, dim=-1)
    return torch.abs(bin_val) ** 2 / (n * n)


def goertzel_magnitude(x: torch.Tensor, frequency: float, sample_rate: float
                       ) -> torch.Tensor:
    """Normalized tone magnitude (0..~1 for a full-scale tone)."""
    return 2.0 * torch.sqrt(goertzel_power(x, frequency, sample_rate))


# ---------------------------------------------------------------------------
# IIR biquad (RBJ cookbook designs; transposed direct form II)
# ---------------------------------------------------------------------------

def biquad_design(kind: str, frequency: float, sample_rate: float,
                  q: float = 0.7071) -> tuple[np.ndarray, np.ndarray]:
    """(b, a) coefficients for a 2nd-order section.

    kind: 'lowpass' | 'highpass' | 'bandpass' | 'notch'. Matches the filter
    types the reference's IIRBiQuadraticFilter provides
    (dsp/filter/iir/IIRBiQuadraticFilter.java:43).
    """
    w0 = 2.0 * math.pi * frequency / sample_rate
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "lowpass":
        b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
    elif kind == "highpass":
        b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
    elif kind == "bandpass":
        b = np.array([alpha, 0.0, -alpha])
    elif kind == "notch":
        b = np.array([1.0, -2 * cw, 1.0])
    else:
        raise ValueError(f"unknown biquad kind {kind!r}")
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return (b / a[0]).astype(np.float32), (a / a[0]).astype(np.float32)


def biquad_init(dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Zero (z1, z2) for one channel."""
    return torch.zeros((2,), dtype=dtype, device=resolve_device(device))


def biquad_apply(x: torch.Tensor, b, a, state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming biquad, transposed direct form II, over x (..., N);
    ``state`` (..., 2) carries (z1, z2) per leading index, None for zeros.
    A CPU tensor runs ``biquad_apply_plain``; any other tensor launches the
    kernel of ``dsp/biquad_cuda.py`` (float32 or complex64 rows, real
    coefficients), which launches or raises."""
    if x.device.type == "cpu":
        return biquad_apply_plain(x, b, a, state)
    from .biquad_cuda import biquad_cuda
    return biquad_cuda(x, b, a, state)


def biquad_apply_plain(x: torch.Tensor, b, a,
                       state: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a loop over samples, batched
    over the leading axes, in the kernel's order of operations."""
    if state is None:
        state = torch.zeros((*x.shape[:-1], 2), dtype=x.dtype,
                            device=x.device)
    b0, b1, b2 = torch.as_tensor(np.asarray(b), dtype=x.dtype,
                                 device=x.device)
    _, a1, a2 = torch.as_tensor(np.asarray(a), dtype=x.dtype,
                                device=x.device)
    z1, z2 = state[..., 0], state[..., 1]
    out = torch.empty_like(x)
    for n in range(x.shape[-1]):
        xn = x[..., n]
        yn = b0 * xn + z1
        z1 = b1 * xn - a1 * yn + z2
        z2 = b2 * xn - a2 * yn
        out[..., n] = yn
    return out, torch.stack([z1, z2], dim=-1)


# ---------------------------------------------------------------------------
# CMA (constant-modulus) adaptive equalizer
# ---------------------------------------------------------------------------

def cma_init(tap_count: int = 11, device="cuda") -> torch.Tensor:
    """Center-spike initialization (CMAEqualizer.java:8 uses taps[0]=1)."""
    taps = torch.zeros((tap_count,), dtype=torch.complex64,
                       device=resolve_device(device))
    taps[0] = 1.0
    return taps


def cma_equalize(x: torch.Tensor, taps: torch.Tensor | None = None,
                 modulus: float = 1.0, mu: float = 0.001
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Constant-modulus blind equalizer over a 1-D complex stream.

    Per sample: y = taps . buf; e = y*(|y|^2 - modulus), clipped to unit
    magnitude; taps -= mu*conj(buf)*e (the reference's error and update
    rule, CMAEqualizer.java updateTaps). The adaptation is nonlinear, so
    it has no blocked form: a CPU tensor runs ``cma_equalize_plain``, any
    other tensor launches the kernel of ``dsp/cma_cuda.py`` (up to 32
    taps), which launches or raises.

    Returns (equalized stream, final taps).
    """
    if taps is None:
        taps = cma_init(device=x.device)
    if x.device.type == "cpu":
        return cma_equalize_plain(x, taps, modulus, mu)
    from .cma_cuda import cma_cuda
    return cma_cuda(x, taps, modulus, mu)


def cma_equalize_plain(x: torch.Tensor, taps: torch.Tensor | None = None,
                       modulus: float = 1.0, mu: float = 0.001
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a loop over samples in float32
    real and imaginary parts, in the kernel's operations and order
    (csrc/cma.cu), rows [re; im]: the products tr br - ti bi and tr bi +
    ti br; their sum as a halving tree over the next power of two of the
    tap count, zeros past the taps; |y|^2 = yr yr + yi yi and |e| =
    sqrt(er er + ei ei) (the reference takes both as hypot); the update
    tr -= mu (br er + bi ei), ti -= mu (br ei - bi er)."""
    if taps is None:
        taps = cma_init(device=x.device)
    x = torch.view_as_real(x.to(torch.complex64).contiguous())   # (N, 2)
    taps = taps.to(torch.complex64)
    n_taps = taps.shape[0]
    tree = 1 << (n_taps - 1).bit_length()
    tp = torch.stack([taps.real, taps.imag])                  # (2, n_taps)
    buf = torch.zeros_like(tp)
    out = torch.empty_like(x)
    for n in range(x.shape[0]):
        buf = torch.cat([x[n, :, None], buf[:, :-1]], 1)
        prod = tp * buf                                      # tr br, ti bi
        cross = tp * buf.flip(0)                             # tr bi, ti br
        s = F.pad(torch.stack([prod[0] - prod[1], cross[0] + cross[1]]),
                  (0, tree - n_taps))
        while s.shape[1] > 1:
            half = s.shape[1] // 2
            s = s[:, :half] + s[:, half:]
        y = s[:, 0]
        err = y * ((y * y).sum() - modulus)
        mag = torch.sqrt((err * err).sum())
        err = torch.where(mag > 1.0, err / torch.clamp_min(mag, 1e-12), err)
        step = torch.stack([(buf * err[:, None]).sum(0),     # br er + bi ei
                            buf[0] * err[1] - buf[1] * err[0]])
        tp = tp - mu * step
        out[n] = y
    return torch.view_as_complex(out), torch.complex(tp[0], tp[1])


# ---------------------------------------------------------------------------
# IQ DC correction
# ---------------------------------------------------------------------------

def iq_correction(x: torch.Tensor, ratio: float = 1e-5,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Remove slowly-tracked DC from each rail of a 1-D complex stream.

    Mirrors IQCorrectionFilter (dsp/filter/correction/IQCorrectionFilter.java:24):
    per-rail running mean with coupling `ratio`, subtracted from the signal.
    state = complex running mean. Returns (corrected, new state).
    """
    if state is None:
        state = torch.zeros((), dtype=torch.complex64, device=x.device)
    rails = torch.stack([x.real, x.imag])                   # (2, N)
    means = single_pole(rails, ratio,
                        torch.stack([state.real, state.imag]))
    mean = torch.complex(means[0], means[1])
    return x - mean, mean[-1]


# ---------------------------------------------------------------------------
# Hilbert transform (real -> complex via fs/4 translated half-band filter)
# ---------------------------------------------------------------------------

def hilbert_taps(half_band: np.ndarray) -> tuple[int, float, np.ndarray]:
    """Convert a half-band low-pass into the fs/4 analytic-filter pair.

    Frequency-translating the half-band prototype by fs/4 (h[k] *
    exp(j*pi/2*(k-c))) zeroes every real coefficient except the center tap
    and keeps the odd imaginary ones — the construction the reference uses
    (dsp/filter/hilbert/HilbertTransform.java:25, per Lyons 3e s13.37).

    Returns (center_delay, center_gain, q_taps) where the in-phase path is
    the input delayed by center_delay scaled by center_gain and the
    quadrature path is convolution with q_taps (same length as half_band).
    """
    h = np.asarray(half_band, dtype=np.float64)
    n = len(h)
    if (n + 1) % 4:
        raise ValueError("half-band length N must satisfy (N+1) % 4 == 0")
    c = n // 2
    k = np.arange(n)
    # sign chosen so POSITIVE frequencies are kept (analytic signal): the
    # quadrature path must be +90 deg relative to the delayed in-phase path
    q = -2.0 * h * np.sin(0.5 * np.pi * (k - c))
    q[c] = 0.0
    return c, 2.0 * h[c], q.astype(np.float32)


def real_to_complex(x: torch.Tensor, half_band: np.ndarray,
                    state: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real 1-D samples -> analytic (complex64) samples, suppressing
    negative frequencies, with streaming state of len(taps)-1 samples.
    Returns (analytic signal, new state)."""
    c, gain, q = hilbert_taps(half_band)
    n_hist = len(q) - 1
    if state is None:
        state = torch.zeros((n_hist,), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x])
    # y_q[i] = sum_k q[k] * xp[i + k]: conv1d is that correlation
    qt = torch.as_tensor(q, device=x.device)
    yq = F.conv1d(xp[None, None].to(torch.float32), qt[None, None])[0, 0]
    yi = gain * xp[n_hist - c:n_hist - c + x.shape[0]]
    return torch.complex(yi.to(torch.float32), yq), xp[-n_hist:]
