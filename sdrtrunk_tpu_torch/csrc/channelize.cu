// Polyphase branch sums of the M/2 channelizer for Hopper (sm_90a): the
// (K, M) complex64 blocks that the inverse FFT turns into channels.
//
// Replaces no TPU kernel: the JAX package leaves these sums to XLA
// (sdrtrunk_tpu/dsp/channelizer.py::_channelize_core). Its plain PyTorch
// version is sdrtrunk_tpu_torch/dsp/channelizer.py::branch_sums_plain, T
// shifted multiply-adds over reversed (rows, M) views of the padded input,
// each into a full temporary. On the padded input xp (T M + N samples: T M
// of history, then the block) the plain sums are, for block b < K = 2 N / M
// and branch r < M, with half = M / 2:
//
//   u[b, r] = sum_{q < T} h[q, r] * xp[(b + 2 (T - q)) half - r]
//
// taken on each plane (re, im) apart, from the q = 0 product (not from 0 +
// the product, which would turn a -0 into +0) and then q = 1, ..., T - 1 one
// sum at a time. The kernel takes the same products in the same order, and
// the library is built with --fmad=false, so no product and sum are
// contracted into one rounding: u equals the plain sums bit for bit.
//
// What bounds it: bytes. It reads xp once (8 (T M + N) bytes) and h, and
// writes u once (8 K M): at M = 1024, N = 1024 x 20480 (K = 40960) that is
// 168 MB in and 335 MB out, 0.150 ms at 3.35 TB/s, against 4 T K M = 1.5
// GFLOP, 0.02 ms at the float32 rate. The design keeps the traffic to that:
//
// * one thread a branch r, kThreads consecutive branches a block, so a
//   warp's loads of one window row (xp[s half - r], r ascending) and its
//   stores of one output row (u[b, r]) are each one contiguous 256-byte
//   span;
// * a thread computes P = kBlocks consecutive blocks b0 ... b0 + P - 1 of
//   its branch (both parities). Block b + 2 needs the samples of block b
//   one row of M later, so the P + 2 (T - 1) samples the P outputs take are
//   loaded once each: the window w[i] = xp[(b0 + i + 2 (T - q)) half - r] of
//   tap q is tap q - 1's shifted by two, and two new samples come in a tap.
//   The first tap's P loads are independent, which keeps the card's memory
//   busy;
// * the grid runs the branch tiles of one block range together (the branch
//   tile fastest), so the samples shared by branches r and r + half (xp[s
//   half - r - half] is the next row's xp[s half - r]) and by neighbouring
//   block ranges are read from L2, not twice from memory;
// * P = 16 at every K. Measured on an H100 (M = 1024, T = 9): 0.227 ms
//   at K = 40960 against 0.265 ms at P = 4 and 0.361 ms at P = 1; also the
//   fastest from K = 300 up. Below that P = 1 saves about 1 us a call (2.8
//   against 3.8 us at K = 2), which no path needs.
//
// Layout: xp (T M + N,) complex64 as float2, h (T, M) float32, u (K, M)
// complex64 as float2, all contiguous. M, T and K are C ints; the wrapper
// refuses K M or T M + N above INT_MAX, and the kernel indexes in 64 bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;             // branches a block
constexpr int kBlocks = 16;               // output blocks a thread (P)

// --- the sums ---

__global__ void __launch_bounds__(kThreads)
    channelize_kernel(const float2* __restrict__ xp,
                      const float* __restrict__ h, float2* __restrict__ u,
                      int M, int T, int K, int rtiles) {
  const int r = (blockIdx.x % rtiles) * kThreads + threadIdx.x;
  if (r >= M) return;
  constexpr int P = kBlocks;
  const long long b0 = static_cast<long long>(blockIdx.x / rtiles) * P;
  const long long nb = K - b0 < P ? K - b0 : P;    // this tile's blocks
  const long long half = M / 2;
  // tap 0's row: xp[(b0 + 2 T) half - r]; a tap goes back one row of M
  const float2* row = xp + (b0 + 2LL * T) * half - r;
  float2 w[P], acc[P];
  const float h0 = __ldg(h + r);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    w[i] = i < nb ? __ldg(row + i * half) : make_float2(0.f, 0.f);
    acc[i] = make_float2(h0 * w[i].x, h0 * w[i].y);
  }
  for (int q = 1; q < T; ++q) {
#pragma unroll
    for (int i = P - 1; i >= 2; --i) w[i] = w[i - 2];
    row -= M;
    w[0] = __ldg(row);
    w[1] = __ldg(row + half);
    const float hq = __ldg(h + static_cast<long long>(q) * M + r);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      acc[i].x = acc[i].x + hq * w[i].x;
      acc[i].y = acc[i].y + hq * w[i].y;
    }
  }
  float2* out = u + b0 * M + r;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < nb) out[static_cast<long long>(i) * M] = acc[i];
}

}  // namespace

// u (K, M) = the branch sums of xp (T M + N = T M + K M / 2) under h (T, M);
// returns the CUDA status of the launch (0: launched, or K = 0).
extern "C" int channelize_launch(const void* xp, const void* h, void* u,
                                 int M, int T, int K, void* stream) {
  if (M < 2 || M % 2 || T < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float2*>(xp);
  const auto* hm = static_cast<const float*>(h);
  auto* out = static_cast<float2*>(u);
  const int rtiles = (M + kThreads - 1) / kThreads;
  const long long blocks =
      rtiles * ((static_cast<long long>(K) + kBlocks - 1) / kBlocks);
  channelize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, hm, out, M, T, K, rtiles);
  return static_cast<int>(cudaGetLastError());
}
