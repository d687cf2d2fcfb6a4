"""CUDA wrapper of the Gardner DQPSK symbol-recovery kernel (csrc/gardner.cu).

The kernel replaces ``sdrtrunk_tpu/dsp/pallas_gardner.py::_gardner_kernel``.
Its plain PyTorch version is ``GardnerDQPSKDemodulator.scan_packed``
(dsp/psk.py); ``GardnerDQPSKDemodulator.batched`` sends a CUDA tensor here.
The library is built at first use by ``dsp/nvcc.py``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .nvcc import (MAX_WINDOW, MIN_WINDOW, check_inputs, check_sizes,
                   check_window, load_kernel)

__all__ = ["WINDOWS", "build", "gardner_cuda"]

# the window lengths the kernel takes (11: LSM at 25 kHz; 16: P25 Phase 2
# at 50 kHz; 20: LSM at 48 or 50 kHz)
WINDOWS = range(MIN_WINDOW, MAX_WINDOW + 1)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 18 + [ctypes.c_float] * 7
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; a
    loaded library is kept (a failed build is not, and raises again)."""
    return load_kernel("gardner", "gardner_launch", _ARGTYPES)


def gardner_cuda(demod, x: torch.Tensor, state):
    """Launch the kernel on a (C, T) complex64 CUDA block.

    Returns ((T, C) uint8 ``dibit | valid << 2``, new GardnerState). The
    state is in the reference layout (window (C, W)); outputs are new
    tensors (``out`` zero-filled, the state from ``torch.empty``). Raises
    ValueError on a window length outside ``WINDOWS`` and on a C or T
    above ``nvcc.SYMBOL_LOOP_MAX_C`` / ``_MAX_T`` before it builds or
    launches, and raises on a build failure, on a tensor the kernel does
    not take, and on a nonzero launch status.
    """
    from .psk import GardnerState

    check_window("gardner_cuda", demod)
    check_sizes("gardner_cuda", x)
    lib = build()
    x = check_inputs("gardner_cuda", demod, x, state)
    c, t = x.shape
    w = demod.window_len
    # the kernel writes only the bytes of symbols
    out = torch.zeros((t, c), dtype=torch.uint8, device=x.device)
    new = GardnerState(*[torch.empty_like(a) for a in state])
    k = demod.loop_constants()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gardner_launch(
            x.data_ptr(), t, c, w, demod.bank.data_ptr(),
            *[a.data_ptr() for a in state], out.data_ptr(),
            *[a.data_ptr() for a in new],
            k["sps_min"], k["sps_max"], k["g"], k["dsps_gain"], k["alpha"],
            k["beta"], k["max_pll_freq"], *demod.base_ranges(), stream)
    if rc != 0:
        raise RuntimeError(f"gardner_launch failed with CUDA error {rc} "
                           f"(C={c}, T={t}, W={w})")
    gardner_cuda.launches += 1
    gardner_cuda.launches_by[w] += 1
    return out, new


# launches in all, and by the loop's window length
gardner_cuda.launches = 0
gardner_cuda.launches_by = collections.Counter()
