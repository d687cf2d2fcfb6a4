#!/usr/bin/env python3
"""Device time of the bit-timing kernel (sdrtrunk_tpu_torch/csrc/
bit_timing.cu) against the number of channels a block, on one NVIDIA card.

    python3 tools/bit_timing_blocks.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The kernel's block size is a constant of its source (one channel a block),
so the script builds a copy of the source for each other size into
sdrtrunk_tpu_torch/_build/bit_timing_blocks/ (git-ignored) and launches it
through the product's wrapper. For the LTR geometry at 1023 x 4000 and the AFSK geometry at 1023 x 3600
(chip_smoke.py's inputs) it holds the kernel bit for bit against the plain
loop and prints, for 32, 16, 8, 4, 2 and 1 channels a block, the kernel's
device ms (torch.profiler) and the host's enqueue ms a call of the
wrapper. The channels of a warp sit at independent symbol phases, so the
fewer channels share a warp, the fewer samples on which the warp takes the
symbol branch.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "sdrtrunk_tpu_torch" / "_build" / "bit_timing_blocks"
BLOCKS = (32, 16, 8, 4, 2, 1)
_MARKER = "constexpr int kBlock = 1;"


def _build(block: int) -> ctypes.CDLL:
    """A copy of csrc/bit_timing.cu at `block` channels a block, built with
    the product's flags and loaded with the wrapper's argument types."""
    from sdrtrunk_tpu_torch.dsp import bit_timing_cuda as btc
    from sdrtrunk_tpu_torch.dsp import nvcc

    text = (nvcc.CSRC / "bit_timing.cu").read_text()
    if text.count(_MARKER) != 1:
        raise ValueError(f"bit_timing.cu: marker not found: {_MARKER!r}")
    d = OUT / f"block{block}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "bit_timing.cu").write_text(
        text.replace(_MARKER, f"constexpr int kBlock = {block};"))
    so = d / "libbit_timing.so"
    p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                        str(d / "bit_timing.cu")], capture_output=True,
                       text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {d}/bit_timing.cu:\n{p.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.bit_timing_launch.argtypes = btc._ARGTYPES
    lib.bit_timing_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from sdrtrunk_tpu_torch.convert import tree_map
    from sdrtrunk_tpu_torch.dsp import bit_timing_cuda as btc
    from sdrtrunk_tpu_torch.dsp.bit_timing import bit_timing_plain

    if not torch.cuda.is_available():
        print("bit_timing_blocks.py: no CUDA card", file=sys.stderr)
        return 1
    card = cs._card()
    with ThreadPoolExecutor(len(BLOCKS)) as pool:
        libs = dict(zip(BLOCKS, pool.map(_build, BLOCKS)))
    for which in ("ltr", "afsk"):
        demod, _ = cs._bit_demod(which)
        c, t = cs.KERNEL_C, cs.BIT_T[which]
        s0 = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                      demod.init_state())
        x = demod.front(cs._bit_audio(which, c, t), s0)[0].contiguous()
        args = (demod.geometry, x, s0.window, s0.sampling_point,
                getattr(demod, "invert", False))
        want = bit_timing_plain(*args)
        for block in BLOCKS:
            # the wrapper launches whatever library its build() returns
            btc.build = lambda lib=libs[block]: lib

            def launch():
                return btc.bit_timing_cuda(*args)
            got = launch()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{which}: the kernel differs from the "
                                     f"plain loop at {block} channels a block")
            device_ms = cs._kernel_device_ms(launch, "bit_timing_kernel")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                launch()
            host_ms = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            print(f"{card}: bit_timing {which} C={c} T={t}, {block} channels "
                  f"a block: kernel {device_ms:.4f} ms on the device, "
                  f"{host_ms:.4f} ms of host enqueue a call; identical to "
                  "the plain loop", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
