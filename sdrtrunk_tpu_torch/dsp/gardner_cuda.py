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

from .nvcc import check_inputs, load_kernel

__all__ = ["WINDOWS", "build", "gardner_cuda"]

# window lengths with an instantiation in gardner.cu: LSM at 25 kHz (and
# 6000 Bd at 25 kHz), P25 Phase 2 at 50 kHz
WINDOWS = (11, 16)

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
    on a build failure, on a window length without an instantiation, on a
    tensor the kernel does not take, and on a nonzero launch status.
    """
    from .psk import GardnerState

    w = demod.window_len
    if w not in WINDOWS:
        raise ValueError(
            f"gardner_cuda: window length {w} (sample rate "
            f"{demod.sample_rate}, {demod.symbol_rate} Bd) has no kernel "
            f"instantiation; gardner.cu instantiates W in {WINDOWS}")
    lib = build()
    x = check_inputs("gardner_cuda", demod, x, state)
    c, t = x.shape
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
