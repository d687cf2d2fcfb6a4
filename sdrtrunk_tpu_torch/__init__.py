"""sdrtrunk_tpu_torch — the PyTorch/CUDA port of sdrtrunk_tpu for an NVIDIA
Hopper card (H100, sm_90a).

The JAX package ``sdrtrunk_tpu`` stays the reference: this package keeps its
file layout and public names (``sdrtrunk_tpu/dsp/psk.py`` has its
counterpart at ``sdrtrunk_tpu_torch/dsp/psk.py``), keeps its state layouts
at public functions, and is held against it by ``tests/test_torch_*.py``.
It never imports jax, directly or through a jax-importing
``sdrtrunk_tpu`` module; the framework-free host layer (``protocol``,
``runtime`` state machines and bank processors, ``audio.mbe``,
``signal.generators``, ``dsp.design``, ``dsp.interpolator``) is imported
as it is.

Plain tensor code is PyTorch. The one Pallas kernel on the live P25 Phase 1
path (``sdrtrunk_tpu/dsp/pallas_psk.py::_dqpsk_kernel``) is a CUDA C++
kernel written by hand (``csrc/dqpsk.cu``), built with nvcc at first use.

The device is explicit: every public constructor takes ``device``; the
main path defaults to ``"cuda"`` and raises when CUDA is absent.
"""
from __future__ import annotations

import torch

# A float32 convolution goes through cuDNN in TF32 by default (about three
# decimal digits), which would break the baseband FIR's agreement with the
# reference; matmuls (the IIR's blocked recurrence) get the same guard.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """The explicit device a constructor was given; raises when it names
    CUDA and no CUDA device is available (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return device
