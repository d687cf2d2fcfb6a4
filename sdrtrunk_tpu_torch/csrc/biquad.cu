// Streaming biquad (transposed direct form II) for Hopper (sm_90a), over the
// rows of a (R, N) float32 or complex64 block, each row with its own state.
//
// Replaces the lax.scan of biquad_apply (sdrtrunk_tpu/dsp/misc.py:91, scan
// :109), vmapped over the leading axes; not a Pallas kernel. Its plain
// PyTorch version is sdrtrunk_tpu_torch/dsp/misc.py::biquad_apply_plain. The
// step is the plain loop's, in its order of operations:
//
//   y = b0 * x + z1;  z1 = b1 * x - a1 * y + z2;  z2 = b2 * x - a2 * y
//
// and the library is built with --fmad=false, so no product and sum are
// contracted into one rounding: on the card the two agree bit for bit. The
// coefficients are real (the RBJ designs), so a complex row is two
// independent real recurrences, one on the real parts and one on the
// imaginary parts, which are what the plain loop's complex operations
// compute with a zero imaginary coefficient.
//
// What bounds it: each row's serial chain, not bytes. A sample's y depends
// on z1, which depends on the last sample's y through a product, a
// difference and a sum: four dependent float32 operations a sample (about
// 16 cycles), against 8 bytes a float moved. At the bank's 1023 rows of
// 10240 floats that is 84 MB, 25 us at 3.35 TB/s, and about 90 us of
// chain. So one thread serves a row, with z1 and z2 in registers, and the
// kernel keeps the chain fed: one warp serves 32 rows, and stages tiles of
// kTile floats of each row through shared memory, loaded coalesced (a row's
// tile by the whole warp) while the lanes walk the tile before it, and
// stored coalesced after the walk wrote y over x in place.
//
// Layout: x and y are (R, NF) float32, NF = N floats a row (2 N for a
// complex row: re, im interleaved); the state is (R, 2) float32 (z1, z2) or
// (R, 2, 2) for complex rows ((z1.re, z1.im), (z2.re, z2.im)), as the
// reference's (..., 2) state of the row's dtype.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;                 // rows a warp (= block)
constexpr int kTile = 128;                // floats of a row a tile
constexpr int kPer = kTile / 32;          // floats a lane loads a row

struct Coeffs {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ float step(const Coeffs& k, float x, float& z1,
                                      float& z2) {
  const float y = k.b0 * x + z1;
  z1 = k.b1 * x - k.a1 * y + z2;
  z2 = k.b2 * x - k.a2 * y;
  return y;
}

// Tile t0 .. t0 + kTile - 1 of each of the warp's rows into registers,
// coalesced (a row's tile by the whole warp); 0 past a row's end.
__device__ __forceinline__ void load_tile(float (&next)[kRows][kPer],
                                          const float* __restrict__ xb,
                                          int NF, int rows, int t0, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = t0 + 32 * i + lane;
      next[r][i] = (r < rows && f < NF)
                       ? xb[static_cast<size_t>(r) * NF + f] : 0.f;
    }
}

// kV floats a sample: 1 for float32 rows, 2 (re, im) for complex64 rows.
template <int kV>
__global__ void __launch_bounds__(32)
biquad_kernel(const float* __restrict__ x, float* __restrict__ y, int R,
              int NF, Coeffs k, const float* __restrict__ st_in,
              float* __restrict__ st_out) {
  __shared__ float tile[kRows][kTile + 1];  // +1: a lane's row walk is
                                            // conflict-free
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - r0);
  const bool mine = lane < rows;
  float z1[kV], z2[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    z1[v] = mine ? st_in[(static_cast<size_t>(r0) + lane) * 2 * kV + v] : 0.f;
    z2[v] = mine ? st_in[(static_cast<size_t>(r0) + lane) * 2 * kV + kV + v]
                 : 0.f;
  }
  const float* xb = x + static_cast<size_t>(r0) * NF;
  float* yb = y + static_cast<size_t>(r0) * NF;

  float next[kRows][kPer];                  // the next tile, in flight
  load_tile(next, xb, NF, rows, 0, lane);
  for (int t0 = 0; t0 < NF; t0 += kTile) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kPer; ++i) tile[r][32 * i + lane] = next[r][i];
    __syncwarp();
    if (t0 + kTile < NF) load_tile(next, xb, NF, rows, t0 + kTile, lane);
    const int n = min(kTile, NF - t0);      // a multiple of kV
    if (mine) {
      float* row = tile[lane];
#pragma unroll 8
      for (int f = 0; f < n; f += kV) {
#pragma unroll
        for (int v = 0; v < kV; ++v)
          row[f + v] = step(k, row[f + v], z1[v], z2[v]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int f = t0 + 32 * i + lane;
        if (r < rows && f < NF)
          yb[static_cast<size_t>(r) * NF + f] = tile[r][32 * i + lane];
      }
    __syncwarp();
  }
  if (mine) {
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      st_out[(static_cast<size_t>(r0) + lane) * 2 * kV + v] = z1[v];
      st_out[(static_cast<size_t>(r0) + lane) * 2 * kV + kV + v] = z2[v];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int biquad_launch(const void* x, void* y, int R, int N,
                             int is_complex, float b0, float b1, float b2,
                             float a1, float a2, const void* st_in,
                             void* st_out, void* stream) {
  if (R < 0 || N < 0 || N > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const Coeffs k{b0, b1, b2, a1, a2};
  const int grid = (R + kRows - 1) / kRows;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  auto* ys = static_cast<float*>(y);
  const auto* si = static_cast<const float*>(st_in);
  auto* so = static_cast<float*>(st_out);
  if (is_complex)
    biquad_kernel<2><<<grid, 32, 0, st>>>(xs, ys, R, 2 * N, k, si, so);
  else
    biquad_kernel<1><<<grid, 32, 0, st>>>(xs, ys, R, N, k, si, so);
  return static_cast<int>(cudaGetLastError());
}
