#!/usr/bin/env python3
"""Where the biquad and CMA kernels (sdrtrunk_tpu_torch/csrc/biquad.cu,
csrc/cma.cu) spend their time, on one NVIDIA card: their phase split.

    python3 tools/recurrence_split.py [--csrc DIR ...] [--latency]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The script builds, into sdrtrunk_tpu_torch/_build/recurrence_split/
(git-ignored), each kernel as it is and a copy with clock64() read around
its phases, by the text edits ``_CLOCK`` (one set for the kernels' phase
markers, the ``// --- name`` comments, and one for the earlier generation
of 32 rows a warp and a tap a lane, which has none), plus the variants
``_VARIANTS`` of the current generation (the CMA with every tap in one
lane and with four taps a lane, the biquad at 16 rows a warp). Every copy
launches through its C entry point at chip_smoke.py's shapes and inputs:
the biquad at 1023 x 10240 float32 and complex64, the CMA on 20000
samples at 11 and 32 taps. Each is held bit for bit against its plain
version on the card (``biquad_apply_plain``, ``cma_equalize_plain``). It
prints one JSON line per case and copy: the device ms (CUDA events around
REPS launches queued behind a sleep, chip_smoke._device_span_ms: the
kernels back to back, not the host's enqueue) and, for the clock64
copies, the mean cycles a sample of each phase (lane 0 of each warp) with
the card's SM clock beside them:

* biquad: stage (waiting for a tile and starting the next copies), walk
  (the recurrence over a tile) and store (y out of shared memory), a
  row's cycles over its samples;
* CMA: line (the earlier generation's shift of the line; now from one
  sample's end to the next one's products: the line's reads, the loop, a
  block's clip check and a tile's staging), products and tree (the taps'
  products and their sum), error, clip (the earlier generation's square
  root and divisions; now the test alone, the square root and divisions
  on the rare path) and update (the taps', and y's store).

A clock read runs once the instructions before it have been dispatched,
not when their results are ready: a phase that waits on an earlier phase's
result (a load, a shuffle) counts the wait as its own.

First it prints the card's latencies the chains are made of (cycles a
step of a dependent float32 add, multiply, butterfly shuffle into an add,
and add into an untaken branch; and the symbol and bit-timing kernels'
links: fma_f64's round trip through double, the mix's double cos and
sin, a double reciprocal square root, an add with wrap's compare-selects,
a shared-memory load, a popcount into an add; ``_LATENCY``). With
--latency it prints that line and the symbol and bit-timing kernels'
chain floors (``chain_floors``: the dependent links a symbol takes, read
from the code, at those latencies and the card's top SM clock), and
stops.

--csrc DIR also times and splits the biquad.cu and cma.cu of another
kernel generation (e.g. an older commit's csrc/ unpacked with git archive
into a git-ignored directory) in the same run. Nothing here is imported
by the port; the copies are never part of the tree.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "sdrtrunk_tpu_torch" / "_build" / "recurrence_split"
CLK_WORDS = 4 * 1024
REPS = {"biquad": 20, "cma": 5}
PHASES = {"biquad": ("stage", "walk", "store"),
          "cma": ("line", "products_tree", "error", "clip", "update")}

_G_CLK = ("namespace {\n",
          "__device__ unsigned long long g_clk[4 * 1024];\nnamespace {\n")

# (marker, replacement) sets a kernel's clock64 copy is made with: the
# first set whose every marker is in the source once is applied
_CLOCK = {
    "biquad": (
        # the phase markers: lane 0 of each warp keeps its sums in
        # g_clk[4 * warp ...], the row's samples last
        (_G_CLK,
         ("  // --- start\n",
          "  unsigned long long c_stage = 0, c_walk = 0, c_store = 0;\n"
          "  long long ta = clock64(), tb = ta, tc = ta;\n"),
         ("    // --- stage\n", "    ta = clock64();\n"),
         ("    // --- walk\n",
          "    tb = clock64();\n    c_stage += tb - ta;\n"),
         ("    // --- store\n",
          "    tc = clock64();\n    c_walk += tc - tb;\n"),
         ("    // --- next\n", "    c_store += clock64() - tc;\n"),
         ("  // --- end\n",
          "  if (lane == 0) {\n"
          "    const int w = blockIdx.x;\n"
          "    if (w < 1024) {\n"
          "      g_clk[4 * w] = c_stage;\n      g_clk[4 * w + 1] = c_walk;\n"
          "      g_clk[4 * w + 2] = c_store;\n"
          "      g_clk[4 * w + 3] = NF / kV;\n    }\n  }\n")),
        # the earlier kernel: 32 rows a one-warp block, the next tile in
        # registers
        (_G_CLK,
         ("  float next[kRows][kPer];",
          "  unsigned long long c_stage = 0, c_walk = 0, c_store = 0;\n"
          "  float next[kRows][kPer];"),
         ("  for (int t0 = 0; t0 < NF; t0 += kTile) {\n",
          "  for (int t0 = 0; t0 < NF; t0 += kTile) {\n"
          "    const long long ta = clock64();\n"),
         ("    const int n = min(kTile, NF - t0);",
          "    const long long tb = clock64();\n    c_stage += tb - ta;\n"
          "    const int n = min(kTile, NF - t0);"),
         ("    __syncwarp();\n#pragma unroll\n"
          "    for (int r = 0; r < kRows; ++r)\n"
          "#pragma unroll\n      for (int i = 0; i < kPer; ++i) {\n"
          "        const int f = t0 + 32 * i + lane;\n"
          "        if (r < rows && f < NF)\n          yb",
          "    const long long tc = clock64();\n    c_walk += tc - tb;\n"
          "    __syncwarp();\n#pragma unroll\n"
          "    for (int r = 0; r < kRows; ++r)\n"
          "#pragma unroll\n      for (int i = 0; i < kPer; ++i) {\n"
          "        const int f = t0 + 32 * i + lane;\n"
          "        if (r < rows && f < NF)\n          yb"),
         ("    __syncwarp();\n  }\n  if (mine) {\n",
          "    __syncwarp();\n    c_store += clock64() - tc;\n  }\n"
          "  if (lane == 0) {\n"
          "    g_clk[4 * blockIdx.x] = c_stage;\n"
          "    g_clk[4 * blockIdx.x + 1] = c_walk;\n"
          "    g_clk[4 * blockIdx.x + 2] = c_store;\n"
          "    g_clk[4 * blockIdx.x + 3] = NF / kV;\n  }\n  if (mine) {\n")),
    ),
    "cma": (
        # the phase markers: lane 0 keeps its sums in g_clk[0 .. 4], the
        # samples in g_clk[5] (those of the guessed blocks, every sample of
        # a stream of whole blocks where no clip fires); "line" runs from a
        # sample's end to the next one's products (the line's reads, the
        # loop, a block's check, a tile's staging)
        (_G_CLK,
         ("  // --- start\n",
          "  unsigned long long c_[5] = {}, n_s = 0;\n"
          "  long long q0 = clock64(), q1 = 0, q2 = 0, q3 = 0, q4 = 0;\n"),
         ("    // --- products\n",
          "    q1 = clock64();\n    c_[0] += q1 - q0;\n"),
         ("    // --- error\n", "    q2 = clock64();\n    c_[1] += q2 - q1;\n"),
         ("    // --- clip\n", "    q3 = clock64();\n    c_[2] += q3 - q2;\n"),
         ("    // --- update\n",
          "    q4 = clock64();\n    c_[3] += q4 - q3;\n"),
         ("    // --- next\n",
          "    q0 = clock64();\n    c_[4] += q0 - q4;\n    ++n_s;\n"),
         ("  // --- end\n",
          "  if (threadIdx.x == 0) {\n"
          "    for (int i = 0; i < 5; ++i) g_clk[i] = c_[i];\n"
          "    g_clk[5] = n_s;\n  }\n")),
        # the earlier kernel: a tap a lane, the line shifted by shuffles
        (_G_CLK,
         ("  float br = 0.f, bi = 0.f;                 // buf[lane]\n",
          "  float br = 0.f, bi = 0.f;                 // buf[lane]\n"
          "  unsigned long long c_[5] = {}, n_s = 0;\n"),
         ("      // shift the line: buf[lane] = buf[lane - 1], buf[0] = x\n",
          "      const long long q0 = clock64();\n"
          "      // shift the line: buf[lane] = buf[lane - 1], buf[0] = x\n"),
         ("      // y = sum of taps * buf: the halving tree over `tree` "
          "lanes\n",
          "      const long long q1 = clock64();\n      c_[0] += q1 - q0;\n"
          "      // y = sum of taps * buf: the halving tree over `tree` "
          "lanes\n"),
         ("      // the error, clipped to magnitude 1\n",
          "      const long long q2 = clock64();\n      c_[1] += q2 - q1;\n"
          "      // the error, clipped to magnitude 1\n"),
         ("      const float mag = sqrtf(er * er + ei * ei);\n",
          "      const long long q3 = clock64();\n      c_[2] += q3 - q2;\n"
          "      const float mag = sqrtf(er * er + ei * ei);\n"),
         ("      if (on) {\n        tr = tr - mu",
          "      const long long q4 = clock64();\n      c_[3] += q4 - q3;\n"
          "      if (on) {\n        tr = tr - mu"),
         ("      if (lane == 0) sy[k] = make_float2(yr, yi);\n",
          "      c_[4] += clock64() - q4;\n      ++n_s;\n"
          "      if (lane == 0) sy[k] = make_float2(yr, yi);\n"),
         ("  if (on) taps_out[lane] = make_float2(tr, ti);\n",
          "  if (on) taps_out[lane] = make_float2(tr, ti);\n"
          "  if (lane == 0) {\n"
          "    for (int i = 0; i < 5; ++i) g_clk[i] = c_[i];\n"
          "    g_clk[5] = n_s;\n  }\n")),
    ),
}

# other designs of the current generation, by one edit each; a generation
# without the line is not varied
_VARIANTS = {
    "cma": {"one_lane": ("constexpr int kLaneTaps = 2;",
                         "constexpr int kLaneTaps = 32;"),
            "four_a_lane": ("constexpr int kLaneTaps = 2;",
                            "constexpr int kLaneTaps = 4;")},
    "biquad": {"rows16": ("constexpr int kRows = 8;",
                          "constexpr int kRows = 16;")},
}

# The card's latencies the chains are made of, one warp, each a chain of
# kIters dependent steps between two clock64 reads: a float32 add, a
# float32 multiply, a butterfly shuffle feeding an add (one level of the
# CMA's tree), and an add feeding a compare and a branch not taken around
# a square root and a division (the CMA's clip test)
_LATENCY = r"""
#include <cuda_runtime.h>
constexpr int kIters = 4096;
constexpr float kTwoPi = 6.28318530717958647692f;
template <int kKind>
__global__ void chain(float* out, long long* cyc, float a, float b, float c) {
  __shared__ int next[32];
  next[threadIdx.x] = (threadIdx.x + 1) & 31;
  __syncwarp();
  float x = a + 1e-7f * threadIdx.x;        // not uniform across the warp
  int j = threadIdx.x;
  unsigned u = threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < kIters; ++i) {
    if (kKind == 0) x = x + b;
    if (kKind == 1) x = x * b;
    if (kKind == 2) x = __shfl_xor_sync(0xffffffffu, x, 1) + b;
    if (kKind == 3) {
      x = x + b;
      if (x > c) x = x / sqrtf(x);
    }
    // the symbol kernels' fma_f64 (psk_common.cuh): floats to double, one
    // fused multiply-add, rounded back
    if (kKind == 4)
      x = static_cast<float>(static_cast<double>(x) * static_cast<double>(b)
                             + static_cast<double>(c));
    // their mix's cos and sin of a float phase in double, rounded, added
    if (kKind == 5)
      x = static_cast<float>(cos(static_cast<double>(x))) +
          static_cast<float>(sin(static_cast<double>(x)));
    // diff_norm's reciprocal square root in double
    if (kKind == 6)
      x = static_cast<float>(1.0 / sqrt(static_cast<double>(x)));
    // the run's phase step: an add, then wrap's two compare-selects
    if (kKind == 7) {
      x = x + b;
      x = x > kTwoPi ? x - kTwoPi : x;
      x = x < -kTwoPi ? x + kTwoPi : x;
    }
    if (kKind == 8) j = next[j];                 // a shared-memory load
    if (kKind == 9) u = __popc(u ^ 0x5a5a5a5au) + u;  // popcount, add
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x + static_cast<float>(j) + static_cast<float>(u);
  if (threadIdx.x == 0) *cyc = t1 - t0;
}
extern "C" int latency(void* out, void* cyc, int kind) {
  auto* o = static_cast<float*>(out);
  auto* c = static_cast<long long*>(cyc) + kind;
  const float a = 1.f, b = 1.0000001f, big = 3.0e38f;
  if (kind == 0) chain<0><<<1, 32>>>(o, c, a, b, big);
  if (kind == 1) chain<1><<<1, 32>>>(o, c, a, b, big);
  if (kind == 2) chain<2><<<1, 32>>>(o, c, a, b, big);
  if (kind == 3) chain<3><<<1, 32>>>(o, c, a, 1e-30f, big);
  if (kind == 4) chain<4><<<1, 32>>>(o, c, a, b, 1e-7f);
  if (kind == 5) chain<5><<<1, 32>>>(o, c, 0.5f, b, big);
  if (kind == 6) chain<6><<<1, 32>>>(o, c, 2.f, b, big);
  if (kind == 7) chain<7><<<1, 32>>>(o, c, a, 0.7f, big);
  if (kind == 8) chain<8><<<1, 32>>>(o, c, a, b, big);
  if (kind == 9) chain<9><<<1, 32>>>(o, c, a, b, big);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
LATENCY_ITERS = 4096
LATENCY_KINDS = ("fadd", "fmul", "shfl_xor_then_fadd",
                 "fadd_then_untaken_branch", "fma_f64", "cos_sin_f64",
                 "rsqrt_f64", "fadd_then_wrap", "shared_load",
                 "popc_then_add")


# The loop-carried chain of a symbol (the symbol kernels) or of a bit
# symbol (the bit timing), in the links ``_LATENCY`` measures, read from
# the code. "fadd" stands for any float32 or integer add, multiply,
# compare or select; branches are left out (the code's, not the chain's),
# so the floor is below what any form of the loop can take.
#
# The symbol loops (psk_common.cuh symbol_loop, dqpsk.cu / gardner.cu
# step), per symbol: the run, one phase step (add, wrap) a sample from the
# last update to the symbol's sample (the counter steps beside it); then
# the step, whose longest path reaches the interpolated point either
# through the counter (clip, arm, the tap load, the 8-tap sum: a product
# and 7 fma_f64) or through the mix of the run sample under the last tap
# (its phase steps, cos and sin, the mix's product and fma_f64, the ring
# store read back, the last fma_f64); then diff_norm (3 products, 2
# fma_f64, the square root), the decision or the Gardner detector, and
# the timing and PLL update back to the next run.
_SYMBOL_TAILS = {
    # decide (7) and update (5 adds or selects, 2 fma_f64)
    "dqpsk": {"fadd": 3 + 7 + 5, "fma_f64": 2 + 2, "rsqrt_f64": 1},
    # the detector (5 and an fma_f64), the update's counter path (3, 2)
    "gardner": {"fadd": 3 + 5 + 3, "fma_f64": 2 + 1 + 2, "rsqrt_f64": 1},
}
# (case, kernel, samples a symbol, window W, the last tap's window index
# through the run's mixes, T) at chip_smoke.KERNELS' live shapes
SYMBOL_CHAINS = (("dqpsk", "dqpsk", 25000.0 / 4800.0, 10, 7, 10240),
                 ("dqpsk_p25p2", "dqpsk", 50000.0 / 6000.0, 16, 7, 20480),
                 ("dqpsk_w20", "dqpsk", 50000.0 / 4800.0, 20, 7, 10240),
                 ("gardner_p25p2", "gardner", 50000.0 / 6000.0, 16, 11,
                  20480),
                 ("gardner_lsm", "gardner", 25000.0 / 4800.0, 11, 9,
                  10240))
# The bit timing's walk (bit_timing.cu), per bit symbol: the counter to
# its symbol (a conversion, a compare, the sample index), the line's
# words from shared memory (one load), their funnel shift, bit reversal
# and masks, the crossings' xor, shift and mask, the crossing's bit
# (clz), its distance, conversion and error (about 16 adds, compares or
# selects in all, 3 bit-count links), the counter's fma_f64.
BIT_CHAIN = {"fadd": 16, "shared_load": 1, "popc_then_add": 3, "fma_f64": 1}
# (case, samples a symbol, T) at chip_smoke's LTR and AFSK shapes
BIT_CHAINS = (("bit_timing_ltr", 8000.0 / 300.0, 4000),
              ("bit_timing_afsk", 7200.0 / 1200.0, 3600))


def chain_floors(lat: dict, sm_mhz: float) -> dict:
    """Each chain's cycles a symbol at the latencies ``lat`` (cycles a
    link) and its floor in ms at ``sm_mhz``: symbols a channel (T over the
    samples a symbol) times the cycles, whatever the channel count."""
    def cycles(links):
        return sum(n * lat[k] for k, n in links.items())

    out = {}
    for case, kernel, sps, w, tap, t in SYMBOL_CHAINS:
        through_counter = sps * lat["fadd_then_wrap"] + cycles(
            {"fadd": 6, "shared_load": 1, "fma_f64": 8})
        steps = tap + 1 - (w - sps)       # the run's phase steps to it
        through_mix = 0.0 if steps <= 0 else steps * lat[
            "fadd_then_wrap"] + cycles({"cos_sin_f64": 1, "fadd": 1,
                                        "fma_f64": 2, "shared_load": 1})
        per = max(through_counter, through_mix) + cycles(
            _SYMBOL_TAILS[kernel])
        out[case] = {"symbols": t / sps, "cycles_per_symbol": per,
                     "through_counter": through_counter,
                     "through_mix": through_mix,
                     "ms": t / sps * per / (sm_mhz * 1e3)}
    for case, sps, t in BIT_CHAINS:
        per = cycles(BIT_CHAIN)
        out[case] = {"symbols": t / sps, "cycles_per_symbol": per,
                     "ms": t / sps * per / (sm_mhz * 1e3)}
    return out


def _latency() -> dict:
    """Cycles a step of each chain of ``_LATENCY`` (lane 0's clock64)."""
    import torch

    from sdrtrunk_tpu_torch.dsp import nvcc

    d = OUT / "latency"
    d.mkdir(parents=True, exist_ok=True)
    (d / "latency.cu").write_text(_LATENCY)
    p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o",
                        str(d / "liblatency.so"), str(d / "latency.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for the latency chains:\n{p.stderr}")
    lib = ctypes.CDLL(str(d / "liblatency.so"))
    lib.latency.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.latency.restype = ctypes.c_int
    out = torch.zeros(32, device="cuda")
    cyc = torch.zeros(len(LATENCY_KINDS), dtype=torch.int64, device="cuda")
    for kind in range(len(LATENCY_KINDS)):
        for _ in range(2):                  # the second launch is kept
            if lib.latency(out.data_ptr(), cyc.data_ptr(), kind) != 0:
                raise RuntimeError("the latency chain failed")
    return {k: float(v) / LATENCY_ITERS
            for k, v in zip(LATENCY_KINDS, cyc.cpu().tolist())}


_READ_CLK = """
extern "C" int read_clk(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_clk, n * 8));
}
"""


def instrument(kernel: str, text: str) -> str:
    """The clock64 copy of a biquad.cu or cma.cu, by the first edit set of
    ``_CLOCK[kernel]`` whose markers are each there once; raises
    ValueError if none is."""
    for edits in _CLOCK[kernel]:
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            return text + _READ_CLK
    raise ValueError(f"{kernel}.cu: no edit set of _CLOCK finds its markers")


def _build(d: Path, kernel: str, text: str, clock: bool):
    from sdrtrunk_tpu_torch.dsp import biquad_cuda, cma_cuda, nvcc

    d.mkdir(parents=True, exist_ok=True)
    src = d / f"{kernel}.cu"
    src.write_text(text)
    so = d / f"lib{kernel}.so"
    p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                        str(src)], capture_output=True, text=True)
    (d / "ptxas.txt").write_text(p.stdout + p.stderr)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = (biquad_cuda if kernel == "biquad" else cma_cuda)._ARGTYPES
    fn.restype = ctypes.c_int
    if clock:
        lib.read_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.read_clk.restype = ctypes.c_int
    return lib, _registers(p.stdout + p.stderr)


def _registers(report: str) -> list[str]:
    """ptxas's "Used N registers" and spill lines, one a kernel."""
    return [ln.strip() for ln in report.splitlines()
            if re.search(r"Used \d+ registers|spill", ln)]


def _biquad(lib, x, b, a):
    import torch

    from sdrtrunk_tpu_torch.dsp.biquad_cuda import _real_coefficients

    b0, b1, b2 = _real_coefficients("split", "b", b)
    _, a1, a2 = _real_coefficients("split", "a", a)
    st = torch.zeros((x.shape[0], 2), dtype=x.dtype, device=x.device)
    y, new = torch.empty_like(x), torch.empty_like(st)
    rc = lib.biquad_launch(x.data_ptr(), y.data_ptr(), x.shape[0],
                           x.shape[1], int(x.dtype == torch.complex64), b0,
                           b1, b2, a1, a2, st.data_ptr(), new.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"biquad_launch failed with CUDA error {rc}")
    return y, new


def _cma(lib, x, taps):
    import numpy as np
    import torch

    y, new = torch.empty_like(x), torch.empty_like(taps)
    rc = lib.cma_launch(x.data_ptr(), y.data_ptr(), x.shape[0],
                        taps.shape[0], taps.data_ptr(), new.data_ptr(), 1.0,
                        float(np.float32(0.003)),
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cma_launch failed with CUDA error {rc}")
    return y, new


def _sm_clock_mhz() -> list[str]:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().split(", ")


def _copies(args) -> dict:
    """{(generation, kernel, copy): (source text, clocked)}."""
    from sdrtrunk_tpu_torch.dsp import nvcc

    copies = {}
    for gen, d in [("tree", nvcc.CSRC)] + [(str(d), d) for d in args.csrc]:
        for kernel in ("biquad", "cma"):
            text = (d / f"{kernel}.cu").read_text()
            designs = {"as_is": text}
            if gen == "tree":
                for name, (old, new) in _VARIANTS[kernel].items():
                    if text.count(old) == 1:
                        designs[name] = text.replace(old, new)
            for name, src in designs.items():
                copies[(gen, kernel, name)] = (src, False)
                copies[(gen, kernel, f"{name}+clock")] = (
                    instrument(kernel, src), True)
    return copies


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, action="append", default=[])
    ap.add_argument("--latency", action="store_true",
                    help="print the latency chains' line alone")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sdrtrunk_tpu_torch.dsp import misc

    if not torch.cuda.is_available():
        print("recurrence_split.py: no CUDA card", file=sys.stderr)
        return 1
    print(cs._card(), flush=True)
    if args.latency:
        lat, clocks = _latency(), _sm_clock_mhz()
        print(json.dumps({"latency_cycles_per_step": lat,
                          "sm_clock_mhz_now_max": clocks}), flush=True)
        print(json.dumps({"chain_floors": chain_floors(
            lat, float(clocks[-1].split()[0]))}), flush=True)
        return 0
    copies = _copies(args)
    with ThreadPoolExecutor(len(copies)) as pool:
        futures = {key: pool.submit(_build, OUT / f"copy{i}", key[1], src,
                                    clock)
                   for i, (key, (src, clock)) in enumerate(copies.items())}
        libs = {key: f.result() for key, f in futures.items()}
    inputs = cs._dsp_inputs()
    b, a = inputs["b"], inputs["a"]
    cases = []
    for dtype, rows in (("float32", inputs["rows"]),
                        ("complex64", inputs["crows"])):
        x = torch.as_tensor(rows, device="cuda")
        cases.append(("biquad", f"{dtype} {list(x.shape)}", x.shape[1],
                      lambda lib, x=x: _biquad(lib, x, b, a),
                      lambda x=x: misc.biquad_apply_plain(x, b, a)))
    xq = torch.as_tensor(inputs["qpsk"], device="cuda")
    for n_taps in (11, 32):
        taps = misc.cma_init(n_taps, device="cuda")
        cases.append(("cma", f"{n_taps} taps, {xq.shape[0]} samples",
                      xq.shape[0], lambda lib, t=taps: _cma(lib, xq, t),
                      lambda t=taps: misc.cma_equalize_plain(xq, t,
                                                             mu=0.003)))
    print(json.dumps({"latency_cycles_per_step": _latency(),
                      "sm_clock_mhz_now_max": _sm_clock_mhz()}), flush=True)
    for kernel, case, samples, launch, plain in cases:
        want = plain()
        for (gen, k, copy), (lib, regs) in libs.items():
            if k != kernel:
                continue
            got = launch(lib)
            torch.cuda.synchronize()
            for what, g, w in zip(("output", "state"), got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{kernel} {case} {gen} {copy}: "
                                         f"{what} differs from the plain "
                                         "version on the card")
            rec = {"kernel": kernel, "case": case, "csrc": gen, "copy": copy,
                   "device_ms": cs._device_span_ms(lambda: launch(lib),
                                                   reps=REPS[kernel]),
                   "identical_to_plain": True, "ptxas": regs}
            if copies[(gen, k, copy)][1]:
                buf = torch.zeros(CLK_WORDS, dtype=torch.int64)
                launch(lib)
                torch.cuda.synchronize()
                if lib.read_clk(buf.data_ptr(), CLK_WORDS) != 0:
                    raise RuntimeError("read_clk failed")
                rec["cycles_per_sample"] = _split(kernel, buf, samples)
                rec["sm_clock_mhz_now_max"] = _sm_clock_mhz()
            print(json.dumps(rec), flush=True)
    print(cs._card(), flush=True)
    return 0


def _split(kernel: str, buf, samples: int) -> dict:
    """Mean cycles a sample of each phase from the g_clk words."""
    names = PHASES[kernel]
    if kernel == "cma":
        n = int(buf[5])
        if n != samples:
            raise AssertionError(f"cma: {n} samples clocked, not {samples}")
        per = {p: float(buf[i]) / n for i, p in enumerate(names)}
    else:
        rows = buf.view(-1, 4)
        rows = rows[rows[:, 3] > 0].double()   # the warps that walked
        if not len(rows) or not bool((rows[:, 3] == samples).all()):
            raise AssertionError("biquad: a warp clocked another row length")
        per = {p: float((rows[:, i] / rows[:, 3]).mean())
               for i, p in enumerate(names)}
    per["total"] = sum(per.values())
    return per


if __name__ == "__main__":
    sys.exit(main())
