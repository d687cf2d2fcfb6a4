// Boolean bit-timing loop for Hopper (sm_90a): slicing at 0, a delay line of
// W decisions, majority-vote bits and a zero-crossing timing correction.
//
// Replaces the lax.scan of LTRFSKDemodulator._step
// (sdrtrunk_tpu/dsp/fsk.py:108, step :64-96) and of
// AFSK1200Demodulator._step (sdrtrunk_tpu/dsp/afsk.py:129, step :95-112);
// neither is a Pallas kernel. Its plain PyTorch version is
// sdrtrunk_tpu_torch/dsp/bit_timing.py::bit_timing_plain; the two use the
// same float32 operations in the same order, so on the card they agree bit
// for bit.
//
// The reference keeps the delay line as a W-element int8 array and slices,
// sums and arg-maxes it on every sample. W <= 64, so here the whole line is
// one 64-bit register a channel, newest decision in bit 0 (window[i] of the
// reference layout is bit W - 1 - i): a shift takes the new decision in,
// the vote is a popcount under a mask, the crossings are w ^ (w >> 1) under
// a mask (crossing i of the reference is bit zc_len - 2 - i), their count a
// popcount, and the first and last crossing come from clz and ffs.
//
// What bounds it: each channel's serial chain, not bytes (1023 x 4000
// floats in and the two (C, T) byte planes out move 24.5 MB, 7 us at 3.35
// TB/s). One thread a channel runs the per-sample loop; a tile of samples
// is loaded ahead of the steps that use it, so the loads of a tile overlap.
// A block is one channel (kBlock: a warp with one lane at work): the
// channels of a warp sit at independent symbol phases, so a warp of 32
// takes the symbol branch on nearly every sample (32 channels, a symbol
// every 27 samples or every 6). On the H100, 1023 x 4000 at the LTR
// geometry took 0.56 ms at 32 channels a block, 0.31 at 8 and 0.24 at 1
// (tools/bit_timing_blocks.py, which builds copies of this file with other
// values of kBlock); 1023 warps are 8 a multiprocessor.
//
// Layout: x is (C, T) float32; bits (C, T) int8 and valid (C, T) bool are
// written only at symbols (the caller zero-fills them); the state is in the
// JAX reference's layout: window (C, W) int8 (newest last), sampling_point
// (C,) float32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 1;    // channels (threads) a block
constexpr int kTile = 16;    // samples loaded ahead of their steps

struct Geometry {
  int window_len;
  int zc_len;
  int vote_half;             // majority: votes > vote_len / 2
  int two_crossings;         // FSK rule for exactly two crossings
  int invert;
  uint64_t line_mask;        // the W bits of the delay line
  uint64_t vote_mask;
  uint64_t zc_mask;          // bits 0 .. zc_len - 2
  float zc_ideal;
  float sps;
  float gain;
};

// The symbol step: the voted bit and the new counter.
__device__ __forceinline__ int8_t symbol(uint64_t w, const Geometry& g,
                                         float& sp) {
  const int votes = __popcll(w & g.vote_mask);
  const uint64_t cr = (w ^ (w >> 1)) & g.zc_mask;
  const int count = __popcll(cr);
  float error = 0.0f;
  if (count == 1 || (count == 2 && g.two_crossings)) {
    const int first = g.zc_len - 2 - (63 - __clzll(static_cast<long long>(cr)));
    error = (static_cast<float>(first) + 0.5f) - g.zc_ideal;
    if (count == 2) {
      const int last = g.zc_len - 2 - (__ffsll(static_cast<long long>(cr)) - 1);
      const float err2 = (static_cast<float>(last) + 0.5f) - g.zc_ideal;
      error = (fabsf(error) < fabsf(err2)) ? error : err2;
    }
  }
  // fma(error, gain, sp + sps) as the plain loop takes it: the float64
  // product (exact) plus sum, rounded once
  sp = static_cast<float>(static_cast<double>(error) *
                              static_cast<double>(g.gain) +
                          static_cast<double>(sp + g.sps));
  return votes > g.vote_half ? 1 : 0;
}

__global__ void __launch_bounds__(kBlock)
bit_timing_kernel(const float* __restrict__ x, int T, int C, Geometry g,
                  const int8_t* __restrict__ win_in,
                  const float* __restrict__ sp_in, int8_t* __restrict__ bits,
                  uint8_t* __restrict__ valid, int8_t* __restrict__ win_out,
                  float* __restrict__ sp_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int W = g.window_len;
  uint64_t w = 0;
  for (int i = 0; i < W; ++i)
    w = (w << 1) | static_cast<uint64_t>(win_in[static_cast<size_t>(c) * W + i] != 0);
  float sp = sp_in[c];
  const size_t row = static_cast<size_t>(c) * T;
  const float* xr = x + row;

  for (int t0 = 0; t0 < T; t0 += kTile) {
    float v[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) v[j] = (t0 + j < T) ? xr[t0 + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (t0 + j < T) {
        const bool d = (v[j] > 0.0f) != (g.invert != 0);
        w = ((w << 1) | static_cast<uint64_t>(d)) & g.line_mask;
        sp = sp - 1.0f;
        if (sp < 1.0f) {
          bits[row + t0 + j] = symbol(w, g, sp);
          valid[row + t0 + j] = 1;
        }
      }
    }
  }

  for (int i = 0; i < W; ++i)
    win_out[static_cast<size_t>(c) * W + i] =
        static_cast<int8_t>((w >> (W - 1 - i)) & 1);
  sp_out[c] = sp;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a geometry the 64-bit line cannot
// hold (2 <= zc_len <= W <= 64, the vote window inside the line).
extern "C" int bit_timing_launch(
    const void* x, int T, int C, int W, int vote_start, int vote_len,
    int zc_len, int two_crossings, int invert, const void* win_in,
    const void* sp_in, void* bits, void* valid, void* win_out, void* sp_out,
    float zc_ideal, float sps, float gain, void* stream) {
  if (C <= 0) return 0;
  if (W > 64 || zc_len < 2 || zc_len > W || vote_start < 0 || vote_len < 1 ||
      vote_start + vote_len > W || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto ones = [](int n) -> uint64_t {
    return n >= 64 ? ~0ull : (1ull << n) - 1ull;
  };
  Geometry g;
  g.window_len = W;
  g.zc_len = zc_len;
  g.vote_half = vote_len / 2;
  g.two_crossings = two_crossings;
  g.invert = invert;
  g.line_mask = ones(W);
  // window[vote_start .. vote_start + vote_len) = bits W - vote_start -
  // vote_len .. W - 1 - vote_start
  g.vote_mask = ones(vote_len) << (W - vote_start - vote_len);
  g.zc_mask = ones(zc_len - 1);
  g.zc_ideal = zc_ideal;
  g.sps = sps;
  g.gain = gain;
  const int grid = (C + kBlock - 1) / kBlock;
  bit_timing_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), T, C, g,
      static_cast<const int8_t*>(win_in), static_cast<const float*>(sp_in),
      static_cast<int8_t*>(bits), static_cast<uint8_t*>(valid),
      static_cast<int8_t*>(win_out), static_cast<float*>(sp_out));
  return static_cast<int>(cudaGetLastError());
}
