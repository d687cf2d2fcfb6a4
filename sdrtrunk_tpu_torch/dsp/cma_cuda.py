"""CUDA wrapper of the CMA equalizer kernel (csrc/cma.cu).

The kernel replaces the reference's ``lax.scan`` of ``cma_equalize``
(sdrtrunk_tpu/dsp/misc.py:123, scan :150). Its plain PyTorch version is
``cma_equalize_plain`` (dsp/misc.py); ``cma_equalize`` sends a CUDA tensor
here. The library is built at first use by ``dsp/nvcc.py``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .nvcc import check_count, check_tensor, load_kernel

__all__ = ["MAX_TAPS", "build", "cma_cuda"]

# the most taps the kernel takes (csrc/cma.cu: its delay line carries 31
# samples across tiles, and its tree spreads over at most one warp)
MAX_TAPS = 32

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
              ctypes.c_float, ctypes.c_void_p])


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; a
    loaded library is kept (a failed build is not, and raises again)."""
    return load_kernel("cma", "cma_launch", _ARGTYPES)


def cma_cuda(x: torch.Tensor, taps: torch.Tensor, modulus: float = 1.0,
             mu: float = 0.001):
    """Launch the kernel on a 1-D CUDA stream, cast to complex64 as the
    plain loop casts it, from taps (n_taps,) (cast likewise). Returns
    (equalized stream (N,) complex64, final taps), new tensors. Raises
    ValueError on a tap count outside 1 .. MAX_TAPS, on a stream longer
    than a C int holds and on a tensor the kernel does not take before it
    builds or launches, and raises on a build failure and on a nonzero
    launch status."""
    name = "cma_cuda"
    if x.dim() != 1 or taps.dim() != 1:
        raise ValueError(f"{name}: x and taps must be 1-D, got "
                         f"{tuple(x.shape)} and {tuple(taps.shape)}")
    n_taps = taps.shape[0]
    if not 1 <= n_taps <= MAX_TAPS:
        raise ValueError(f"{name}: {n_taps} taps; the kernel takes 1 to "
                         f"{MAX_TAPS}, over the lanes of one warp")
    check_count(name, "N", x.shape[0])
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be on a CUDA device, got {x.device}")
    x = x.to(torch.complex64).contiguous()
    taps = taps.to(torch.complex64).contiguous()
    check_tensor(name, "taps", taps, torch.complex64, (n_taps,), x.device)
    lib = build()
    y = torch.empty_like(x)
    new_taps = torch.empty_like(taps)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cma_launch(x.data_ptr(), y.data_ptr(), x.shape[0], n_taps,
                            taps.data_ptr(), new_taps.data_ptr(),
                            float(np.float32(modulus)), float(np.float32(mu)),
                            stream)
    if rc != 0:
        raise RuntimeError(f"cma_launch failed with CUDA error {rc} "
                           f"(N={x.shape[0]}, taps={n_taps})")
    cma_cuda.launches += 1
    cma_cuda.launches_by[n_taps] += 1
    return y, new_taps


# launches in all, and by the tap count
cma_cuda.launches = 0
cma_cuda.launches_by = collections.Counter()
