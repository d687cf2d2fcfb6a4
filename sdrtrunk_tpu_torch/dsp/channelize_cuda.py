"""CUDA wrapper of the channelizer's branch-sum kernel (csrc/channelize.cu).

The kernel replaces no TPU kernel: the reference leaves the branch sums of
``_channelize_core`` (sdrtrunk_tpu/dsp/channelizer.py) to XLA. Its plain
PyTorch version is ``branch_sums_plain`` (dsp/channelizer.py);
``channelize_core`` sends a CUDA tensor here. The library is built at first
use by ``dsp/nvcc.py``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..runtime import tracing
from .nvcc import check_count, check_tensor, load_kernel

__all__ = ["build", "channelize_cuda"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; a
    loaded library is kept (a failed build is not, and raises again)."""
    return load_kernel("channelize", "channelize_launch", _ARGTYPES)


def channelize_cuda(xp: torch.Tensor, hmat: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the padded block xp ((T M + N,) complex64, N a
    multiple of M) under the branches hmat ((T, M) float32, M even), both
    contiguous on one CUDA device. Returns the branch sums u ((K, M)
    complex64, K = 2 N / M), a new tensor, equal to ``branch_sums_plain``'s
    bit for bit. Raises ValueError on another shape, dtype, layout or
    device, and on K M or T M + N above a C int, before it builds or
    launches; raises on a build failure and on a nonzero launch status."""
    name = "channelize_cuda"
    if hmat.dim() != 2 or xp.dim() != 1:
        raise ValueError(f"{name}: xp must be (T M + N,) and hmat (T, M); "
                         f"got {tuple(xp.shape)} and {tuple(hmat.shape)}")
    t, m = hmat.shape
    n = xp.shape[0] - t * m
    if m < 2 or m % 2 or t < 1 or n < 0 or n % m:
        raise ValueError(f"{name}: needs an even M >= 2, T >= 1 and N a "
                         f"multiple of M; got M = {m}, T = {t}, N = {n}")
    k = 2 * n // m
    check_count(name, "K M", k * m)
    check_count(name, "T M + N", xp.shape[0])
    if xp.device.type != "cuda":
        raise ValueError(f"{name}: xp must be on a CUDA device, got "
                         f"{xp.device}")
    check_tensor(name, "xp", xp, torch.complex64, (t * m + n,), xp.device)
    check_tensor(name, "hmat", hmat, torch.float32, (t, m), xp.device)
    u = torch.empty((k, m), dtype=torch.complex64, device=xp.device)
    if k == 0:                              # nothing to launch
        return u
    lib = build()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = lib.channelize_launch(xp.data_ptr(), hmat.data_ptr(),
                                   u.data_ptr(), m, t, k, stream)
    if rc != 0:
        raise RuntimeError(f"channelize_launch failed with CUDA error {rc} "
                           f"(M={m}, T={t}, K={k})")
    channelize_cuda.launches += 1
    channelize_cuda.launches_by[str(xp.dtype).removeprefix("torch.")] += 1
    tracing.count("channelize.kernel")
    return u


# launches in all, and by input dtype (complex64: the only one it takes)
channelize_cuda.launches = 0
channelize_cuda.launches_by = collections.Counter()
