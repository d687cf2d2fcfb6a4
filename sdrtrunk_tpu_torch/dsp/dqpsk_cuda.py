"""CUDA wrapper of the DQPSK symbol-recovery kernel (csrc/dqpsk.cu).

The kernel replaces ``sdrtrunk_tpu/dsp/pallas_psk.py::_dqpsk_kernel``.
Its plain PyTorch version is ``DQPSKDemodulator.scan_packed``
(dsp/psk.py); ``DQPSKDemodulator.batched`` sends a CUDA tensor here.

The source is compiled with nvcc at first use into ``_build/`` (listed in
.gitignore), under a name keyed by a hash of the source and the flags, and
loaded with ctypes. Nothing is built or imported at module import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["build", "dqpsk_cuda"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dqpsk.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the DQPSK "
                       "kernel is built from csrc/dqpsk.cu with nvcc")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"libdqpsk_{key[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.dqpsk_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int] + [ctypes.c_void_p] * 16
                       + [ctypes.c_float] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"dqpsk_cuda: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def dqpsk_cuda(demod, x: torch.Tensor, state):
    """Launch the kernel on a (C, T) complex64 CUDA block.

    Returns ((T, C) uint8 ``dibit | valid << 2``, new DQPSKState). The
    state is in the reference layout (window (C, W)); outputs are new
    tensors from ``torch.empty``. Raises on a build failure, on a tensor
    the kernel does not take, and on a nonzero launch status.
    """
    from .psk import DQPSKState

    lib = build()
    if x.device.type != "cuda":
        raise ValueError(f"dqpsk_cuda: x must be on a CUDA device, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"dqpsk_cuda: x must be (C, T), got {tuple(x.shape)}")
    dev = x.device
    c, t = x.shape
    w = demod.window_len
    xt = x.T.contiguous()                              # (T, C) stream
    _check("x", xt, torch.complex64, (t, c), dev)
    _check("bank", demod.bank, torch.float32, (129, 8), dev)
    _check("window", state.window, torch.complex64, (c, w), dev)
    for name in ("sampling_point", "detected_sps", "pll_phase", "pll_freq"):
        _check(name, getattr(state, name), torch.float32, (c,), dev)
    for name in ("prev_preceding", "prev_current"):
        _check(name, getattr(state, name), torch.complex64, (c,), dev)

    out = torch.empty((t, c), dtype=torch.uint8, device=dev)
    new = DQPSKState(*[torch.empty_like(a) for a in state])
    k = demod.loop_constants()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dqpsk_launch(
            xt.data_ptr(), t, c, w, demod.bank.data_ptr(),
            *[a.data_ptr() for a in state], out.data_ptr(),
            *[a.data_ptr() for a in new],
            k["sps_min"], k["sps_max"], k["g"], k["dsps_gain"], k["alpha"],
            k["beta"], k["max_pll_freq"], stream)
    if rc != 0:
        raise RuntimeError(f"dqpsk_launch failed with CUDA error {rc} "
                           f"(C={c}, T={t}, W={w})")
    dqpsk_cuda.launches += 1
    return out, new


dqpsk_cuda.launches = 0
