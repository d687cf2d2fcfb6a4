"""Build and load of the port's CUDA kernels (``csrc/<name>.cu``), and the
input checks their wrappers share.

Each kernel source is compiled with nvcc at first use into ``_build/``
(listed in .gitignore) as a shared library with a plain C interface, under
a name keyed by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, and loaded with ctypes. Nothing is built at import. ptxas
reports each kernel's registers, shared memory and spills (``-Xptxas -v``);
the report is kept beside the library as ``lib<name>_<key>.log``.

The symbol-loop kernels (dqpsk.cu, gardner.cu) take the same inputs: a
(C, T) complex64 stream, the (129, 8) interpolator bank and the state in
the reference layout, at a window length W in [MIN_WINDOW, MAX_WINDOW];
``check_window`` and ``check_inputs`` refuse anything else. Every kernel
takes its counts as C ints, which ctypes wraps without a word (2**31 + 5
arrives as -2147483643, 2**32 + 5 as 5): ``check_count`` refuses a count
above what the entry point and the kernel's index hold, before any build
or launch.
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

__all__ = ["BUILD_DIR", "CSRC", "INT_MAX", "MAX_WINDOW", "MIN_WINDOW",
           "NVCC_FLAGS", "SYMBOL_LOOP_MAX_C", "SYMBOL_LOOP_MAX_T",
           "check_count", "check_inputs", "check_sizes", "check_tensor",
           "check_window", "lane_layout", "load_kernel", "ptxas_report",
           "ring_size"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

# the window lengths the symbol-loop kernels take (csrc/psk_common.cuh
# kMinWindow, kMaxWindow): 4 to 64 samples a symbol
MIN_WINDOW, MAX_WINDOW = 8, 128

# the largest C int, the type of every kernel's counts
INT_MAX = 2**31 - 1
# the symbol-loop kernels' limits: the grid (C + 3) / 4 blocks at most,
# and a pass reads up to 63 samples past its start
SYMBOL_LOOP_MAX_C, SYMBOL_LOOP_MAX_T = INT_MAX - 3, INT_MAX - 63

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's "
                       "kernels are built from sdrtrunk_tpu_torch/csrc with nvcc")


def _library(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """ptxas's report (registers, spills) from the build of ``name``."""
    return _library(name).with_suffix(".log").read_text()


def load_kernel(name: str, symbol: str, argtypes: list) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per key) and load it; ``symbol``
    gets ``argtypes`` and an int return (its CUDA status). Raises
    RuntimeError when nvcc fails."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        so = _library(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return lib


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise ValueError unless t is a contiguous dtype tensor of shape on
    device."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def check_count(kernel: str, name: str, value: int,
                limit: int = INT_MAX) -> None:
    """Raise ValueError unless 0 <= value <= limit: a count the kernel's C
    entry point (an int) and its index hold. Checked before any build or
    launch, and before the device check, so a test can show it on a meta
    tensor."""
    if not 0 <= value <= limit:
        raise ValueError(f"{kernel}: {name} = {value} is above the kernel's "
                         f"limit of {limit} (its C entry point takes a "
                         f"32-bit int)")


def check_sizes(kernel: str, x: torch.Tensor) -> None:
    """The symbol-loop kernels' counts of a (C, T) block (another shape is
    left to ``check_inputs``)."""
    if x.dim() == 2:
        check_count(kernel, "C", x.shape[0], SYMBOL_LOOP_MAX_C)
        check_count(kernel, "T", x.shape[1], SYMBOL_LOOP_MAX_T)


def check_inputs(kernel: str, demod, x: torch.Tensor, state) -> torch.Tensor:
    """Check x, the bank and the state (window (C, W) complex64, then four
    (C,) float32 and the rest (C,) complex64 leaves) against what a symbol
    loop kernel takes; returns x as the contiguous (C, T) stream the kernel
    reads, one row a channel."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: x must be on a CUDA device, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{kernel}: x must be (C, T), got {tuple(x.shape)}")
    dev = x.device
    c, t = x.shape
    x = x.contiguous()
    check_tensor(kernel, "x", x, torch.complex64, (c, t), dev)
    check_tensor(kernel, "bank", demod.bank, torch.float32, (129, 8), dev)
    check_tensor(kernel, "window", state.window, torch.complex64,
                 (c, demod.window_len), dev)
    for i, name in enumerate(state._fields[1:]):
        check_tensor(kernel, name, getattr(state, name),
                     torch.float32 if i < 4 else torch.complex64, (c,), dev)
    return x


def lane_layout(w: int) -> tuple[int, int, int]:
    """(G, K, ring size) the symbol-loop kernels launch with at window
    length w (csrc/psk_common.cuh ``with_lanes`` and ``ring_size``): G
    lanes a channel, K mixes a lane per pass, the delay line a ring of the
    smallest power of two at least w and at least G * K samples."""
    g, k = (8, 1) if w <= 12 else (16, 1) if w <= 31 else \
        (32, 1) if w <= 63 else (32, 2)
    return g, k, ring_size(w, g * k)


def ring_size(w: int, n: int) -> int:
    """The symbol-loop kernels' delay-line ring for window length w and a
    pass of n samples (csrc/psk_common.cuh ``ring_size``): the smallest
    power of two at least w and at least n."""
    size = 1
    while size < max(w, n):
        size *= 2
    return size


def check_window(kernel: str, demod) -> None:
    """Raise ValueError unless the symbol loop's window length is one the
    kernels take; checked before any build or launch."""
    w = demod.window_len
    if not MIN_WINDOW <= w <= MAX_WINDOW:
        raise ValueError(
            f"{kernel}: window length W = {w} ({demod.sample_rate} Hz, "
            f"{demod.symbol_rate} Bd) is outside the kernel's "
            f"[{MIN_WINDOW}, {MAX_WINDOW}]: at most {MAX_WINDOW // 2} "
            f"samples a symbol")
