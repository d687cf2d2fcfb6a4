"""CUDA wrapper of the biquad kernel (csrc/biquad.cu).

The kernel replaces the reference's ``lax.scan`` of ``biquad_apply``
(sdrtrunk_tpu/dsp/misc.py:91, scan :109). Its plain PyTorch version is
``biquad_apply_plain`` (dsp/misc.py); ``biquad_apply`` sends a CUDA tensor
here. The library is built at first use by ``dsp/nvcc.py``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from .nvcc import check_count, check_tensor, load_kernel

__all__ = ["build", "biquad_cuda"]

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
             + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 3)


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; a
    loaded library is kept (a failed build is not, and raises again)."""
    return load_kernel("biquad", "biquad_launch", _ARGTYPES)


def _real_coefficients(name: str, what: str, c) -> list[float]:
    """The three coefficients as float32 values, as the plain loop casts
    them to a float32 row's dtype (or a complex64 row's real part); the
    kernel takes real coefficients only."""
    c = np.asarray(c)
    if c.shape != (3,) or (np.iscomplexobj(c) and np.any(c.imag != 0)):
        raise ValueError(f"{name}: {what} must be three real coefficients, "
                         f"got {c!r}")
    return [float(np.float32(v)) for v in np.real(c)]


def biquad_cuda(x: torch.Tensor, b, a, state: torch.Tensor | None = None):
    """Launch the kernel on a (..., N) float32 or complex64 CUDA tensor,
    one row a leading index, with state (..., 2) (z1, z2) of x's dtype
    (None: zeros). Returns (y like x, new state), new tensors. Raises
    ValueError on another dtype, on complex coefficients, on more rows or
    samples a row than a C int holds (the kernel indexes a row in 64 bits)
    and on a state the kernel does not take before it builds or launches,
    and raises on a build failure and on a nonzero launch status."""
    name = "biquad_cuda"
    if x.dtype not in (torch.float32, torch.complex64) or x.dim() < 1:
        raise ValueError(f"{name}: x must be a float32 or complex64 tensor "
                         f"(..., N), got {x.dtype} {tuple(x.shape)}")
    b0, b1, b2 = _real_coefficients(name, "b", b)
    _, a1, a2 = _real_coefficients(name, "a", a)
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    rows = math.prod(lead)
    check_count(name, "rows", rows)
    check_count(name, "N", n)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be on a CUDA device, got {x.device}")
    if state is None:
        state = torch.zeros((*lead, 2), dtype=x.dtype, device=x.device)
    state = state.contiguous()
    check_tensor(name, "state", state, x.dtype, (*lead, 2), x.device)
    lib = build()
    x = x.contiguous()
    y = torch.empty_like(x)
    if rows == 0:                           # nothing to launch
        return y, state.clone()
    new_state = torch.empty_like(state)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.biquad_launch(
            x.data_ptr(), y.data_ptr(), rows, n,
            int(x.dtype == torch.complex64), b0, b1, b2, a1, a2,
            state.data_ptr(), new_state.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"biquad_launch failed with CUDA error {rc} "
                           f"(rows={rows}, N={n}, {x.dtype})")
    biquad_cuda.launches += 1
    biquad_cuda.launches_by[str(x.dtype).removeprefix("torch.")] += 1
    return y, new_state


# launches in all, and by the row dtype
biquad_cuda.launches = 0
biquad_cuda.launches_by = collections.Counter()
