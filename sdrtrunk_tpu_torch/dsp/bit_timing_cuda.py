"""CUDA wrapper of the bit-timing kernel (csrc/bit_timing.cu).

The kernel replaces the ``lax.scan`` of the reference's two boolean
timing loops (sdrtrunk_tpu/dsp/fsk.py:108, sdrtrunk_tpu/dsp/afsk.py:129).
Its plain PyTorch version is ``bit_timing_plain`` (dsp/bit_timing.py);
``bit_timing`` sends a CUDA tensor here. The library is built at first use
by ``dsp/nvcc.py``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .nvcc import INT_MAX, check_count, check_tensor, load_kernel

__all__ = ["MAX_C", "MAX_T", "MAX_WINDOW", "build", "bit_timing_cuda"]

# the longest delay line the kernel takes: eight 64-bit words
# (csrc/bit_timing.cu kMaxLineWords); LTR at 300 Bd up to 76.8 kHz audio
MAX_WINDOW = 512
# the most channels and samples a channel (C ints): the grid (C + 3) / 4
# blocks, and a tile's end t0 + 8192 (csrc/bit_timing.cu kTile)
MAX_C, MAX_T = INT_MAX - 3, INT_MAX - 8192

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 6
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; a
    loaded library is kept (a failed build is not, and raises again)."""
    return load_kernel("bit_timing", "bit_timing_launch", _ARGTYPES)


def bit_timing_cuda(geom, x: torch.Tensor, window: torch.Tensor,
                    sampling_point: torch.Tensor, invert: bool = False):
    """Launch the kernel on a (C, T) float32 CUDA block.

    Returns (bits (C, T) int8, valid (C, T) bool, new window (C, W) int8,
    new sampling_point (C,) float32), all new tensors. The kernel writes
    every byte of ``bits`` and ``valid``; ``bits`` is 0 wherever ``valid``
    is not set. Raises ValueError on a window length above ``MAX_WINDOW``
    and on a C or T above ``MAX_C`` / ``MAX_T`` before it builds or
    launches, and raises on a build failure, on a tensor the kernel does
    not take, and on a nonzero launch status.
    """
    name = "bit_timing_cuda"
    w = geom.window_len
    if w > MAX_WINDOW:
        raise ValueError(
            f"{name}: window length W = {w} (sps {geom.sps}) is above the "
            f"kernel's {MAX_WINDOW}, its longest delay line")
    if x.dim() == 2:
        check_count(name, "C", x.shape[0], MAX_C)
        check_count(name, "T", x.shape[1], MAX_T)
    lib = build()
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be on a CUDA device, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (C, T), got {tuple(x.shape)}")
    dev = x.device
    c, t = x.shape
    x = x.contiguous()
    check_tensor(name, "x", x, torch.float32, (c, t), dev)
    check_tensor(name, "window", window, torch.int8, (c, w), dev)
    check_tensor(name, "sampling_point", sampling_point, torch.float32, (c,),
                 dev)
    bits = torch.empty((c, t), dtype=torch.int8, device=dev)
    valid = torch.empty((c, t), dtype=torch.bool, device=dev)
    new_window = torch.empty_like(window)
    new_sp = torch.empty_like(sampling_point)
    k = geom.constants()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bit_timing_launch(
            x.data_ptr(), t, c, w, geom.vote_start, geom.vote_len,
            geom.zc_len, int(geom.two_crossings), int(invert),
            window.data_ptr(), sampling_point.data_ptr(), bits.data_ptr(),
            valid.data_ptr(), new_window.data_ptr(), new_sp.data_ptr(),
            k["zc_ideal"], k["sps"], k["gain"], stream)
    if rc != 0:
        raise RuntimeError(f"bit_timing_launch failed with CUDA error {rc} "
                           f"(C={c}, T={t}, W={w})")
    bit_timing_cuda.launches += 1
    bit_timing_cuda.launches_by[w] += 1
    return bits, valid, new_window, new_sp


# launches in all, and by the loop's window length
bit_timing_cuda.launches = 0
bit_timing_cuda.launches_by = collections.Counter()
