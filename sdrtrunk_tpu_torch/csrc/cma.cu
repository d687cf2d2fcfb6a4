// Constant-modulus (CMA) blind equalizer for Hopper (sm_90a) over one
// complex64 stream.
//
// Replaces the lax.scan of cma_equalize (sdrtrunk_tpu/dsp/misc.py:123, scan
// :150); not a Pallas kernel. Per sample, as the reference (and
// CMAEqualizer.java updateTaps):
//
//   buf = [x, buf[:-1]];  y = taps . buf;  e = y (|y|^2 - modulus),
//   clipped to magnitude 1 (e / max(|e|, 1e-12) where |e| > 1);
//   taps -= mu conj(buf) e
//
// Its plain PyTorch version is sdrtrunk_tpu_torch/dsp/misc.py::
// cma_equalize_plain, written in the same float32 operations in the same
// order: the products tr br - ti bi and tr bi + ti br; their sum over the
// taps as a halving tree over P = the next power of two of the tap count
// (zeros past the taps): s[k] + s[k + P / 2], ..., which is the xor
// butterfly below; |y|^2 = yr yr + yi yi; |e| = sqrt(er er + ei ei)
// (IEEE square root and division, as torch's); the update tr -= mu (br er +
// bi ei), ti -= mu (br ei - bi er). The library is built with --fmad=false,
// so the two agree bit for bit.
//
// What bounds it: the chain from one sample's taps to the next's, not
// bytes (20000 samples in and out move 320 KB, 0.1 us at 3.35 TB/s): the
// product, the sum over the taps, the error, its clip (a square root and a
// division) and the update are some 25 dependent operations, about 200
// cycles with the tree's shuffles. The adaptation is nonlinear, so there is
// no blocked form; one warp serves the stream, lane k holding tap k and
// buf[k] (the tap count is at most 32): the line shifts by one lane a
// sample, the dot product is a product a lane and a butterfly of log2 P
// shuffles, and every lane then holds y and takes the same error. The
// stream is staged through shared memory in tiles of kTile samples, read
// and y written coalesced.
//
// Layout: x, y (N,) complex64 as float2; taps (n_taps,) complex64 in and out.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 1024;               // samples a tile
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
cma_kernel(const float2* __restrict__ x, float2* __restrict__ y, int N,
           int n_taps, int tree, const float2* __restrict__ taps_in,
           float2* __restrict__ taps_out, float modulus, float mu) {
  __shared__ float2 sx[kTile];
  __shared__ float2 sy[kTile];
  const int lane = threadIdx.x;
  const bool on = lane < n_taps;
  float tr = on ? taps_in[lane].x : 0.f, ti = on ? taps_in[lane].y : 0.f;
  float br = 0.f, bi = 0.f;                 // buf[lane]
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int n = min(kTile, N - t0);
    for (int k = lane; k < n; k += 32) sx[k] = x[t0 + k];
    __syncwarp();
    for (int k = 0; k < n; ++k) {
      // shift the line: buf[lane] = buf[lane - 1], buf[0] = x
      const float up_r = __shfl_up_sync(kFull, br, 1);
      const float up_i = __shfl_up_sync(kFull, bi, 1);
      const float2 xn = sx[k];
      br = lane == 0 ? xn.x : up_r;
      bi = lane == 0 ? xn.y : up_i;
      // y = sum of taps * buf: the halving tree over `tree` lanes
      float yr = on ? tr * br - ti * bi : 0.f;
      float yi = on ? tr * bi + ti * br : 0.f;
      for (int off = tree >> 1; off > 0; off >>= 1) {
        yr = yr + __shfl_xor_sync(kFull, yr, off);
        yi = yi + __shfl_xor_sync(kFull, yi, off);
      }
      // the error, clipped to magnitude 1
      const float f = (yr * yr + yi * yi) - modulus;
      float er = yr * f, ei = yi * f;
      const float mag = sqrtf(er * er + ei * ei);
      if (mag > 1.0f) {
        const float d = fmaxf(mag, 1e-12f);
        er = er / d;
        ei = ei / d;
      }
      if (on) {
        tr = tr - mu * (br * er + bi * ei);
        ti = ti - mu * (br * ei - bi * er);
      }
      if (lane == 0) sy[k] = make_float2(yr, yi);
    }
    __syncwarp();
    for (int k = lane; k < n; k += 32) y[t0 + k] = sy[k];
    __syncwarp();
  }
  if (on) taps_out[lane] = make_float2(tr, ti);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a tap count outside 1 .. 32.
extern "C" int cma_launch(const void* x, void* y, int N, int n_taps,
                          const void* taps_in, void* taps_out, float modulus,
                          float mu, void* stream) {
  if (n_taps < 1 || n_taps > 32 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int tree = 1;                             // the next power of two
  while (tree < n_taps) tree <<= 1;
  cma_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), N, n_taps, tree,
      static_cast<const float2*>(taps_in), static_cast<float2*>(taps_out),
      modulus, mu);
  return static_cast<int>(cudaGetLastError());
}
