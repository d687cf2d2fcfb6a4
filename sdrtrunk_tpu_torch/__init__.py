"""sdrtrunk_tpu_torch — the PyTorch/CUDA port of sdrtrunk_tpu for an NVIDIA
Hopper card (H100, sm_90a).

The JAX package ``sdrtrunk_tpu`` stays the reference: this package keeps its
file layout and public names (``sdrtrunk_tpu/dsp/psk.py`` has its
counterpart at ``sdrtrunk_tpu_torch/dsp/psk.py``), keeps its state layouts
at public functions, and is held against it by ``tests/test_torch_*.py``.
It imports nothing of ``sdrtrunk_tpu`` and never imports jax. The
framework-free host layer it needs (``protocol``, the ``runtime`` state
machines and bank processors, ``audio``, ``io.wave``,
``signal.generators``, ``dsp.design``, ``dsp.interpolator``,
``dsp.windows``) is a byte-for-byte copy at the same relative paths; the
manifest in tests/test_torch_host_copy.py lists the copies and holds each
equal to its original, so a fix to one must change both.

Plain tensor code is PyTorch. Each Pallas kernel of the reference
(``sdrtrunk_tpu/dsp/pallas_psk.py::_dqpsk_kernel``,
``sdrtrunk_tpu/dsp/pallas_gardner.py::_gardner_kernel``) is a CUDA C++
kernel written by hand (``csrc/dqpsk.cu``, ``csrc/gardner.cu``), and so is
the boolean bit-timing loop that the reference's FSK and AFSK demodulators
run as a ``lax.scan`` (``csrc/bit_timing.cu``); all three are built with
nvcc at first use.

The device is explicit: every public constructor takes ``device`` and
defaults to ``"cuda"``, raising when CUDA is absent. The two classes that
the copied host code builds without a device (``Orchestrator`` and
``AuxDecoder``, reached from ``monitor.py`` and ``runtime/processors.py``)
default to ``None``, which ``resolve_device`` reads as ``default_device()``:
the card, unless a caller has entered ``use_device("cpu")`` (the CLI's
``--platform cpu``). There is no "CUDA if present" choice anywhere.
"""
from __future__ import annotations

import torch

# A float32 convolution goes through cuDNN in TF32 by default (about three
# decimal digits), which would break the baseband FIR's agreement with the
# reference; matmuls (the IIR's blocked recurrence) get the same guard.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import contextlib

__all__ = ["default_device", "resolve_device", "use_device"]

# a plain module global, not a context variable: the live loop's upload
# and download threads must see the device the caller chose
_DEFAULT_DEVICE = "cuda"


def default_device():
    """The device a constructor given ``device=None`` runs on: ``"cuda"``
    unless a ``use_device`` block says otherwise."""
    return _DEFAULT_DEVICE


@contextlib.contextmanager
def use_device(device):
    """Make ``device`` the default for the block (process-wide, as the
    reference's ``jax_platforms`` switch is); restores it on exit."""
    global _DEFAULT_DEVICE
    prev, _DEFAULT_DEVICE = _DEFAULT_DEVICE, device
    try:
        yield
    finally:
        _DEFAULT_DEVICE = prev


def resolve_device(device) -> torch.device:
    """The device a constructor was given, ``None`` meaning
    ``default_device()``; raises when it names CUDA and no CUDA device is
    available (there is no CPU fallback)."""
    device = torch.device(default_device() if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return device
