"""CUDA wrapper of the DQPSK symbol-recovery kernel (csrc/dqpsk.cu).

The kernel replaces ``sdrtrunk_tpu/dsp/pallas_psk.py::_dqpsk_kernel``.
Its plain PyTorch version is ``DQPSKDemodulator.scan_packed``
(dsp/psk.py); ``DQPSKDemodulator.batched`` sends a CUDA tensor here.
The library is built at first use by ``dsp/nvcc.py``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .nvcc import check_inputs, check_sizes, check_window, load_kernel

__all__ = ["build", "dqpsk_cuda"]

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 16 + [ctypes.c_float] * 7
             + [ctypes.c_void_p])


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; a
    loaded library is kept (a failed build is not, and raises again)."""
    return load_kernel("dqpsk", "dqpsk_launch", _ARGTYPES)


def dqpsk_cuda(demod, x: torch.Tensor, state):
    """Launch the kernel on a (C, T) complex64 CUDA block.

    Returns ((T, C) uint8 ``dibit | valid << 2``, new DQPSKState). The
    state is in the reference layout (window (C, W)); outputs are new
    tensors (``out`` zero-filled, the state from ``torch.empty``). Raises
    ValueError on a window length above ``nvcc.MAX_WINDOW`` and on a C or
    T above ``nvcc.SYMBOL_LOOP_MAX_C`` / ``_MAX_T`` before it builds or
    launches, and raises on a build failure, on a tensor the kernel does
    not take, and on a nonzero launch status.
    """
    from .psk import DQPSKState

    check_window("dqpsk_cuda", demod)
    check_sizes("dqpsk_cuda", x)
    lib = build()
    x = check_inputs("dqpsk_cuda", demod, x, state)
    c, t = x.shape
    w = demod.window_len
    # the kernel writes only the bytes of symbols
    out = torch.zeros((t, c), dtype=torch.uint8, device=x.device)
    new = DQPSKState(*[torch.empty_like(a) for a in state])
    k = demod.loop_constants()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dqpsk_launch(
            x.data_ptr(), t, c, w, demod.bank.data_ptr(),
            *[a.data_ptr() for a in state], out.data_ptr(),
            *[a.data_ptr() for a in new],
            k["sps_min"], k["sps_max"], k["g"], k["dsps_gain"], k["alpha"],
            k["beta"], k["max_pll_freq"], stream)
    if rc != 0:
        raise RuntimeError(f"dqpsk_launch failed with CUDA error {rc} "
                           f"(C={c}, T={t}, W={w})")
    dqpsk_cuda.launches += 1
    dqpsk_cuda.launches_by[(demod.sample_counter_gain, w)] += 1
    return out, new


# launches in all, and by the loop's (timing gain, window length), e.g.
# (0.3, 10) C4FM, (0.4, 10) DMR, (0.3, 16) P25 Phase 2's decision timing
dqpsk_cuda.launches = 0
dqpsk_cuda.launches_by = collections.Counter()
