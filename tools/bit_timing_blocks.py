#!/usr/bin/env python3
"""Where the bit-timing kernel (sdrtrunk_tpu_torch/csrc/bit_timing.cu)
spends its time, on one NVIDIA card: its phase split.

    python3 tools/bit_timing_blocks.py [--csrc DIR ...]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The script builds, into sdrtrunk_tpu_torch/_build/bit_timing_blocks/
(git-ignored), a copy of the kernel as it is and a copy with clock64()
read around its three phases (pack, walk, write), by the text edits
``_CLOCK``, and launches both through the C entry point at the LTR
geometry on 1023 x 4000 and the AFSK geometry on 1023 x 3600
(chip_smoke.py's inputs). Each copy is held bit for bit against the plain
loop. It prints one JSON line per geometry and copy: the kernel's device
ms (torch.profiler: the kernel alone, not the zero fills) and, for the
clock64 copy, the mean cycles a channel of each phase (lane 0 of each
warp), the symbols a channel and the walk's cycles a symbol, with the
card's SM clock beside them.

--csrc DIR also times the bit_timing.cu of another kernel generation (e.g.
an older commit's csrc/ unpacked with git archive into a git-ignored
directory) in the same run, as it is; a generation without the phase
markers is timed and held, not split. Outputs are zero-filled before each
launch, as an older kernel that writes only at symbols needs. Nothing
here is imported by the port; the copies are never part of the tree.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "sdrtrunk_tpu_torch" / "_build" / "bit_timing_blocks"
CLK_WORDS = 4 * 1024

# (marker, replacement): clock64 around the phases of each tile; lane 0
# keeps the sums and the symbol count, one row of g_clk a channel
_CLOCK = (
    ("namespace {\n",
     "__device__ unsigned long long g_clk[4 * 1024];\nnamespace {\n"),
    ("  float sp = sp_in[c];",
     "  unsigned long long c_pack = 0, c_walk = 0, c_write = 0, n_sym = 0;\n"
     "  float sp = sp_in[c];"),
    ("    // --- pack\n",
     "    const long long ta = clock64();\n    // --- pack\n"),
    ("    // --- walk\n",
     "    const long long tb = clock64();\n    c_pack += tb - ta;\n"
     "    // --- walk\n"),
    ("        const int j = i - 1;",
     "        ++n_sym;\n        const int j = i - 1;"),
    ("    // --- write\n",
     "    const long long tc = clock64();\n    c_walk += tc - tb;\n"
     "    // --- write\n"),
    ("    __syncwarp();\n  }\n",
     "    __syncwarp();\n    c_write += clock64() - tc;\n  }\n"),
    ("  if (lane == 0) sp_out[c] = sp;\n",
     "  if (lane == 0) sp_out[c] = sp;\n"
     "  if (lane == 0 && c < 1024) {\n"
     "    g_clk[4 * c] = c_pack;\n    g_clk[4 * c + 1] = c_walk;\n"
     "    g_clk[4 * c + 2] = c_write;\n    g_clk[4 * c + 3] = n_sym;\n"
     "  }\n"),
)
_READ_CLK = """
extern "C" int read_clk(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_clk, n * 8));
}
"""


def instrument(text: str) -> str:
    """The clock64 copy of a bit_timing.cu; raises if a marker is gone."""
    for old, new in _CLOCK:
        if text.count(old) != 1:
            raise ValueError(f"bit_timing.cu: marker not found once: {old!r}")
        text = text.replace(old, new)
    return text + _READ_CLK


def _build(d: Path, text: str, clock: bool):
    from sdrtrunk_tpu_torch.dsp import bit_timing_cuda as btc
    from sdrtrunk_tpu_torch.dsp import nvcc

    d.mkdir(parents=True, exist_ok=True)
    (d / "bit_timing.cu").write_text(text)
    so = d / "libbit_timing.so"
    p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                        str(d / "bit_timing.cu")], capture_output=True,
                       text=True)
    (d / "ptxas.txt").write_text(p.stdout + p.stderr)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {d}/bit_timing.cu:\n{p.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.bit_timing_launch.argtypes = btc._ARGTYPES
    lib.bit_timing_launch.restype = ctypes.c_int
    if clock:
        lib.read_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.read_clk.restype = ctypes.c_int
    return lib


def _launch(lib, geom, x, window, sp, invert):
    """One launch through the C entry point, outputs zero-filled."""
    import torch

    c, t = x.shape
    bits = torch.zeros((c, t), dtype=torch.int8, device=x.device)
    valid = torch.zeros((c, t), dtype=torch.bool, device=x.device)
    new_window, new_sp = torch.empty_like(window), torch.empty_like(sp)
    k = geom.constants()
    rc = lib.bit_timing_launch(
        x.data_ptr(), t, c, geom.window_len, geom.vote_start, geom.vote_len,
        geom.zc_len, int(geom.two_crossings), int(invert), window.data_ptr(),
        sp.data_ptr(), bits.data_ptr(), valid.data_ptr(), new_window.data_ptr(),
        new_sp.data_ptr(), k["zc_ideal"], k["sps"], k["gain"],
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bit_timing_launch failed with CUDA error {rc}")
    return bits, valid, new_window, new_sp


def _kernel_device_ms(fn, reps: int = 20) -> float:
    """Mean device ms of the kernels named bit_timing_kernel over `reps`
    calls of fn, from torch.profiler's device-side events (the tracer may
    drop some: the mean is over the launches it reported; fewer than half
    of the calls, or more than all, raises)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "bit_timing_kernel" in e.key]
    count = sum(e.count for e in events)
    if not reps // 2 <= count <= reps:
        raise AssertionError(f"the profiler saw {count} launches of the "
                             f"kernel in {reps} calls")
    return sum(e.device_time_total for e in events) / count / 1e3


def _sm_clock_mhz() -> list[str]:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().split(", ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, action="append", default=[])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sdrtrunk_tpu_torch.convert import tree_map
    from sdrtrunk_tpu_torch.dsp import nvcc
    from sdrtrunk_tpu_torch.dsp.bit_timing import bit_timing_plain

    if not torch.cuda.is_available():
        print("bit_timing_blocks.py: no CUDA card", file=sys.stderr)
        return 1
    print(cs._card(), flush=True)
    copies = {}
    for tag, d in [("", nvcc.CSRC)] + [(f"{d}:", d) for d in args.csrc]:
        text = (d / "bit_timing.cu").read_text()
        copies[f"{tag}as_is"] = (text, False)
        try:
            copies[f"{tag}clock"] = (instrument(text), True)
        except ValueError:                  # a generation without the phases
            pass
    with ThreadPoolExecutor(len(copies)) as pool:
        futures = {name: pool.submit(_build, OUT / f"copy{i}", src, clock)
                   for i, (name, (src, clock)) in enumerate(copies.items())}
        libs = {name: f.result() for name, f in futures.items()}
    for which in ("ltr", "afsk"):
        demod, _ = cs._bit_demod(which)
        c, t = cs.KERNEL_C, cs.BIT_T[which]
        s0 = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                      demod.init_state())
        x = demod.front(cs._bit_audio(which, c, t), s0)[0].contiguous()
        args_ = (demod.geometry, x, s0.window, s0.sampling_point,
                 getattr(demod, "invert", False))
        want = bit_timing_plain(*args_)
        for name, lib in libs.items():
            got = _launch(lib, *args_)
            torch.cuda.synchronize()
            cs._hold_bits(f"{which} {name}", got, want)
            rec = {"geometry": which, "copy": name, "shape": [c, t],
                   "device_ms": _kernel_device_ms(
                       lambda lib=lib: _launch(lib, *args_)),
                   "identical_to_plain": True}
            if copies[name][1]:
                buf = torch.zeros(CLK_WORDS, dtype=torch.int64)
                _launch(lib, *args_)
                torch.cuda.synchronize()
                if lib.read_clk(buf.data_ptr(), CLK_WORDS) != 0:
                    raise RuntimeError("read_clk failed")
                per = buf.view(-1, 4)[:c].double()
                rec["cycles_per_channel"] = {
                    part: float(per[:, i].mean())
                    for i, part in enumerate(("pack", "walk", "write"))}
                rec["symbols_per_channel"] = float(per[:, 3].mean())
                rec["walk_cycles_per_symbol"] = float(
                    (per[:, 1] / per[:, 3].clamp(min=1)).mean())
                rec["sm_clock_mhz_now_max"] = _sm_clock_mhz()
            print(json.dumps(rec), flush=True)
    print(cs._card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
