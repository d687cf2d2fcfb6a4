#!/usr/bin/env python3
"""Where the symbol-loop kernels spend their time, on one NVIDIA card.

    python3 tools/symbol_loop_split.py [--csrc DIR] [--one-lane]

Builds copies of the DQPSK and Gardner kernels (dqpsk.cu, gardner.cu and
psk_common.cuh from DIR, by default sdrtrunk_tpu_torch/csrc) into
sdrtrunk_tpu_torch/_build/symbol_loop_split/ (git-ignored): as they are,
with clock64() read around the parts of the loop, and the latter with the
float64 cos/sin of the mix replaced by a cheap expression. Each copy runs
at the live shapes (1023 x 10240 at W = 10 and W = 11, 1023 x 20480 at W =
16) on the signals chip_smoke.py uses; the script prints one JSON line per
kernel and copy: the time by CUDA events and, from lane 0 of each channel
(clock64 copies), the mean cycles of each part:

* a per-sample loop (one thread a channel, the layout before the
  symbol-major loop) splits each sample step into the mix with its
  delay-line shift, the symbol branch and the output store, and counts
  the steps on which the warp took the symbol branch;
* the symbol-major loop (psk_common.cuh's symbol_loop) splits each pass
  into the run's chain (its length and phases), its mixes, and the symbol
  step.

--one-lane also builds the symbol-major loop with one lane a channel,
mixing a whole run itself (G = 1), and holds every symbol-major copy bit
for bit against the plain loop at 1023 x 2048. The SASS of each unmodified
kernel (cuobjdump -sass) is counted for float64 multiplies and adds and
for divergent-branch regions (BSSY). Nothing here is imported by the
port; the instrumented copies are never part of the tree.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "sdrtrunk_tpu_torch" / "_build" / "symbol_loop_split"
CLK_WORDS = 1 << 16

# (case, kernel, sample rate, baud, timing gain, T), as chip_smoke.KERNELS
CASES = (("dqpsk", "dqpsk", 25000.0, 4800.0, 0.3, 10240),
         ("gardner_p25p2", "gardner", 50000.0, 6000.0, 0.1, 20480),
         ("gardner_lsm", "gardner", 25000.0, 4800.0, 0.3, 10240))

_CLOCK_SYMBOL_MAJOR = (
    ("namespace psk {\n",
     "namespace psk {\n__device__ unsigned long long g_clk[1 << 16];\n"),
    ("  int t = 0;\n  while (t < T) {\n",
     "  unsigned long long c0 = 0, c1 = 0, c2 = 0, np_ = 0;\n"
     "  int t = 0;\n  while (t < T) {\n    const long long ta = clock64();\n"),
    ("    // --- its mixes",
     "    const long long tb = clock64();\n    c0 += tb - ta;\n"
     "    // --- its mixes"),
    ("    ring.head += n;\n",
     "    const long long tc = clock64();\n    c1 += tc - tb;\n"
     "    ring.head += n;\n"),
    ("      tm.ph = ph;\n    }\n  }\n}",
     "      tm.ph = ph;\n    }\n    c2 += clock64() - tc;\n    ++np_;\n  }\n"
     "  const int gid = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  g_clk[4 * gid] = c0;\n  g_clk[4 * gid + 1] = c1;\n"
     "  g_clk[4 * gid + 2] = c2;\n  g_clk[4 * gid + 3] = np_;\n}"),
)
_CLOCK_PER_SAMPLE = (
    ("namespace {\n",
     "namespace psk {\n__device__ unsigned long long g_clk[1 << 16];\n}\n"
     "namespace {\n"),
    ("  for (int t = 0; t < T; ++t) {\n    const float2 xv = xn;\n",
     "  unsigned long long c0 = 0, c1 = 0, c2 = 0, ns_ = 0;\n"
     "  for (int t = 0; t < T; ++t) {\n    const long long ta = clock64();\n"
     "    const float2 xv = xn;\n"),
    ("    uint8_t o = 0;\n    if (sp1 < 1.0f) {",
     "    uint8_t o = 0;\n    if (__any_sync(__activemask(), sp1 < 1.0f)) ++ns_;\n"
     "    const long long tb = clock64();\n    c0 += tb - ta;\n"
     "    if (sp1 < 1.0f) {"),
    ("    out[static_cast<size_t>(t) * C + c] = o;\n  }\n",
     "    const long long tc = clock64();\n    c1 += tc - tb;\n"
     "    out[static_cast<size_t>(t) * C + c] = o;\n    c2 += clock64() - tc;\n"
     "  }\n  psk::g_clk[4 * c] = c0;\n  psk::g_clk[4 * c + 1] = c1;\n"
     "  psk::g_clk[4 * c + 2] = c2;\n  psk::g_clk[4 * c + 3] = ns_;\n"),
)
_READ_CLK = """
extern "C" int read_clk(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, psk::g_clk, n * 8));
}
"""
# with_lanes' layouts of the live widths (W = 10 and 11; W = 16)
_LANES_8, _LANES_16 = "Lanes<8, 1>", "Lanes<16, 1>"
_NO_TRIG = ((r"mix\(xb\[k\], phs\[k\]\)",
             "make_float2(xb[k].x * phs[k], xb[k].y - phs[k])"),
            (r"mix\(xv, phase\)", "make_float2(xv.x * phase, xv.y - phase)"))


def symbol_major(header: str) -> bool:
    return "symbol_loop" in header


def _replace_all(text: str, pairs, what: str) -> str:
    for old, new in pairs:
        if old not in text:
            raise ValueError(f"{what}: marker not found: {old!r}")
        text = text.replace(old, new, 1)
    return text


def instrument(header: str, sources: dict, clock: bool, no_trig: bool,
               one_lane: bool) -> tuple[str, dict]:
    """Copies of psk_common.cuh and the kernel sources with clock64 reads,
    the cheap mix or the one-lane layout; raises if a marker is gone."""
    major = symbol_major(header)
    out = dict(sources)
    if clock and major:
        header = _replace_all(header, _CLOCK_SYMBOL_MAJOR, "psk_common.cuh")
    if one_lane:
        # G = 1 lane a channel; K covers a run: 7 up to W = 12, 10 to W = 31
        header = _replace_all(header, ((_LANES_8, "Lanes<1, 7>"),
                                       (_LANES_16, "Lanes<1, 10>")),
                              "psk_common.cuh")
    for name, text in out.items():
        if clock and not major:
            text = _replace_all(text, _CLOCK_PER_SAMPLE, name)
        if clock:
            text += _READ_CLK
        if no_trig:
            for pat, new in _NO_TRIG:
                text = re.sub(pat, new, text)
                header = re.sub(pat, new, header)
        out[name] = text
    return header, out


def _build(d: Path, name: str) -> Path:
    from sdrtrunk_tpu_torch.dsp import nvcc

    so = d / f"lib{name}.so"
    p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                        str(d / f"{name}.cu")], capture_output=True, text=True)
    (d / f"{name}.ptxas.txt").write_text(p.stdout + p.stderr)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {d / name}.cu:\n{p.stderr}")
    return so


def _load(so: Path, name: str, clock: bool):
    from sdrtrunk_tpu_torch.dsp import dqpsk_cuda, gardner_cuda

    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = {"dqpsk": dqpsk_cuda._ARGTYPES,
                   "gardner": gardner_cuda._ARGTYPES}[name]
    if clock:
        lib.read_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.read_clk.restype = ctypes.c_int
    return lib


def sass_counts(so: Path) -> dict:
    """DMUL, DADD and BSSY counts per kernel function (lane layout) of a
    library."""
    txt = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : \S*?(dqpsk|gardner)_kernelI((?:Li\d+E)+)E",
                      line)
        if m:                           # <G, K>, or <W, G, K> before
            fn = f"{m.group(1)}<{', '.join(re.findall(r'\d+', m.group(2)))}>"
            counts[fn] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]+)",
                      line)
        if m and fn:
            counts[fn][m.group(1)] += 1
    return {f: {k: c[k] for k in ("DMUL", "DADD", "BSSY")}
            for f, c in counts.items()}


def _ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _split(lib, major: bool, lanes: int, t: int) -> dict:
    """Mean cycles of each part, lane 0 of each channel."""
    import torch

    buf = torch.zeros(CLK_WORDS, dtype=torch.int64)
    if lib.read_clk(buf.data_ptr(), CLK_WORDS) != 0:
        raise RuntimeError("read_clk failed")
    per = buf.view(-1, 4)[::lanes][:1023].double()
    if major:
        passes = per[:, 3]
        return {"passes_per_channel": float(passes.mean()),
                "cycles_per_pass": {
                    part: float((per[:, i] / passes).mean())
                    for i, part in enumerate(("chain", "mixes", "step"))}}
    warps = per[::32]                       # lane 0 of each warp
    return {"cycles_per_sample": {
                part: float(warps[:, i].mean() / t)
                for i, part in enumerate(("mix", "symbol_branch", "store"))},
            "steps_warp_took_symbol_branch": float(warps[:, 3].mean() / t)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path,
                    default=ROOT / "sdrtrunk_tpu_torch" / "csrc")
    ap.add_argument("--one-lane", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sdrtrunk_tpu_torch.dsp import dqpsk_cuda, gardner_cuda, nvcc

    if not torch.cuda.is_available():
        print("symbol_loop_split.py needs a CUDA card", file=sys.stderr)
        return 1
    print(cs._card(), flush=True)
    header = (args.csrc / "psk_common.cuh").read_text()
    sources = {n: (args.csrc / f"{n}.cu").read_text()
               for n in ("dqpsk", "gardner")}
    major = symbol_major(header)
    tag = "symbol_major" if major else "per_sample"
    copies = {"as_is": (False, False, False), "clock": (True, False, False),
              "no_trig": (True, True, False)}
    if args.one_lane and major:
        copies.update({"one_lane": (False, False, True),
                       "one_lane_clock": (True, False, True)})
    jobs = []
    for copy, flags in copies.items():
        d = OUT / f"{tag}_{copy}"
        d.mkdir(parents=True, exist_ok=True)
        h, srcs = instrument(header, sources, *flags)
        (d / "psk_common.cuh").write_text(h)
        for name, text in srcs.items():
            (d / f"{name}.cu").write_text(text)
            jobs.append((copy, name, d))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = {(copy, name): pool.submit(_build, d, name)
                 for copy, name, d in jobs}
        libs = {key: _load(f.result(), key[1], copies[key[0]][0])
                for key, f in built.items()}
    for name in ("dqpsk", "gardner"):
        print(json.dumps({"sass": sass_counts(
            OUT / f"{tag}_as_is" / f"lib{name}.so")}), flush=True)
    mods = {"dqpsk": dqpsk_cuda, "gardner": gardner_cuda}
    for case, kind, rate, baud, gain, t in CASES:
        demod = cs._symbol_loop(kind, rate, baud, gain)
        if args.one_lane and major:
            s0 = cs._fresh_state(demod, cs.KERNEL_C)
            x = cs._signal_block(cs._modulator(kind), 2048, rate, baud)
            plain = demod.scan_batched(x, s0)
            for copy in copies:
                if copy == "no_trig":
                    continue
                mods[kind].build = lambda lib=libs[(copy, kind)]: lib
                cs._hold(f"{case} {copy}", demod.batched(x, s0), plain,
                         type(s0)._fields)
        s0 = cs._fresh_state(demod, cs.KERNEL_C)
        x = cs._signal_block(cs._modulator(kind), t, rate, baud)
        if not major:
            # the per-sample kernels read the (T, C) stream; the wrapper
            # passes the pointer of the (C, T) tensor it is given
            x = x.T.contiguous().reshape(x.shape)
        for copy, (clock, _, one) in copies.items():
            mods[kind].build = lambda lib=libs[(copy, kind)]: lib
            rec = {"case": case, "loop": tag, "copy": copy,
                   "shape": [cs.KERNEL_C, t],
                   "ms": _ms(lambda: demod._kernel(x, s0))}
            if clock:
                lanes = (nvcc.lane_layout(demod.window_len)[0]
                         if major and not one else 1)
                rec.update(_split(libs[(copy, kind)], major, lanes, t))
            print(json.dumps(rec), flush=True)
    print(cs._card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
