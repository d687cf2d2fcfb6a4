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
// (zeros past the taps): s[k] + s[k + P / 2], ...; |y|^2 = yr yr + yi yi;
// |e| = sqrt(er er + ei ei) (IEEE square root and division, as torch's);
// the update tr -= mu (br er + bi ei), ti -= mu (br ei - bi er). The library
// is built with --fmad=false, so the two agree bit for bit.
//
// What bounds it: the chain from one sample's taps to the next's, not
// bytes (20000 samples in and out move 320 KB, 0.1 us at 3.35 TB/s): the
// products, the sum over the taps, the error, its clip and the update are
// some 22 dependent operations a sample. The adaptation is nonlinear, so
// there is no blocked form; one warp serves the stream, and the design
// keeps off the chain what does not depend on the taps:
//
// * the delay line depends on x alone: each lane reads buf[k] = x[n - k]
//   from the staged tile by index (kHist samples of the tile before carried
//   in front of it), a sample ahead, from one running pointer;
// * lane j holds the kLaneTaps taps j + Q i (Q = P / kLaneTaps lanes, i <
//   kLaneTaps), so its own halving sums are the tree's first
//   log2(kLaneTaps) levels element for element, and log2(Q) shuffled
//   levels remain (3 at 11 taps, 4 at 32, none at 2 or fewer). Two taps a
//   lane timed faster than four (two shuffled levels, twice the
//   instructions before them), one, or all in one thread
//   (tools/recurrence_split.py times them);
// * a correctly rounded square root is monotone, so sqrt(m) > 1 exactly
//   when m > 1 + 2^-23 (sqrt(1 + 2^-23) rounds to 1), and the clip rarely
//   fires: blocks of kGuess samples are taken as if it does not, with no
//   branch a sample (a branch waits some 48 cycles on the test), and a
//   block in which it fired is taken again from its first sample's taps,
//   exactly, the square root and the divisions on that path only.
//
// The stream is staged through two shared-memory tiles of kTile samples by
// 8-byte cp.async, the next in flight while the warp walks this one; lane
// 0 writes y.
//
// Layout: x, y (N,) complex64 as float2; taps (n_taps,) complex64 in and
// out. N is a C int (the wrapper refuses more); the kernel indexes the
// stream in 64 bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 2048;               // samples a tile
constexpr int kHist = 32;                 // samples carried before a tile
                                          // (at least the 31 of 32 taps)
constexpr int kLaneTaps = 2;              // taps a lane, at most
constexpr int kGuess = 16;                // samples a block taken as if no
                                          // clip fires (kTile a multiple)
constexpr unsigned kFull = 0xffffffffu;
// the largest float32 whose correctly rounded square root is 1: above it
// |e| > 1, at or below it (and for a NaN) not
constexpr float kClip = 1.00000011920928955078125f;   // 1 + 2^-23

__device__ __forceinline__ void copy8(float2* dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

// P: the tree's width; kT taps a lane (their in-register levels), kQ lanes
template <int P>
__global__ void __launch_bounds__(32)
cma_kernel(const float2* __restrict__ x, float2* __restrict__ y,
           long long N, int n_taps, const float2* __restrict__ taps_in,
           float2* __restrict__ taps_out, float modulus, float mu) {
  constexpr int kT = P < kLaneTaps ? P : kLaneTaps;
  constexpr int kQ = P / kT;
  // a tile and the kHist samples before it, and one sample of slack past
  // it for the read ahead at the tile's end
  __shared__ __align__(16) float2 sx[2][kHist + kTile + 1];
  // the lane, read once: the compiler would otherwise read threadIdx.x (a
  // long-latency S2R) again in every sample to rebuild on[]
  int lane;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  // Slot i of lane j < kQ is tap j + kQ i; a slot past the taps (and every
  // slot of a lane at or above kQ) reads +0 for its line and holds +0 taps,
  // so its products are +0 exactly, the tree's zeros, with no select on
  // the chain (+0 - mu (+0 er + +0 ei) stays +0; once er is NaN every tap
  // and y are NaN in the plain version too).
  bool on[kT];
  float tr[kT], ti[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int tap = lane + kQ * i;
    on[i] = lane < kQ && tap < n_taps;
    tr[i] = on[i] ? taps_in[tap].x : 0.f;
    ti[i] = on[i] ? taps_in[tap].y : 0.f;
  }
  sx[0][lane] = make_float2(0.f, 0.f);      // the line before the stream
  const long long tiles = (N + kTile - 1) / kTile;
  auto fetch = [&](long long t) {           // tile t, a commit group
    if (t < tiles) {
      const long long t0 = t * kTile;
      const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                         N - t0));
      for (int m = lane; m < n; m += 32)
        copy8(&sx[t & 1][kHist + m], x + t0 + m);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // slot i's line value at sample m: p[m - kQ i], p = the tile's line
  // less the lane (an immediate offset from one running pointer)
  auto load = [&](float2 (&b)[kT], const float2* p) {
#pragma unroll
    for (int i = 0; i < kT; ++i)
      b[i] = on[i] ? p[-kQ * i] : make_float2(0.f, 0.f);
  };
  fetch(0);
  // --- start
  // One sample: b its line; its products, tree, error, and its update as
  // if its clip does not fire (into nr, ni); returns whether it fires.
  auto sample = [&](const float2 (&b)[kT], float& yr, float& yi, float& er,
                    float& ei, float (&nr)[kT], float (&ni)[kT]) {
    // --- products
    float pr[kT], pi[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      pr[i] = tr[i] * b[i].x - ti[i] * b[i].y;
      pi[i] = tr[i] * b[i].y + ti[i] * b[i].x;
    }
#pragma unroll
    for (int h = kT / 2; h > 0; h /= 2) {    // the tree's first levels
#pragma unroll
      for (int i = 0; i < h; ++i) {
        pr[i] = pr[i] + pr[i + h];
        pi[i] = pi[i] + pi[i + h];
      }
    }
    yr = pr[0];
    yi = pi[0];
#pragma unroll
    for (int off = kQ / 2; off > 0; off /= 2) {   // and the rest
      yr = yr + __shfl_xor_sync(kFull, yr, off);
      yi = yi + __shfl_xor_sync(kFull, yi, off);
    }
    // --- error
    const float f = (yr * yr + yi * yi) - modulus;
    er = yr * f;
    ei = yi * f;
    // --- clip
    const bool fires = er * er + ei * ei > kClip;
    // --- update
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      nr[i] = tr[i] - mu * (b[i].x * er + b[i].y * ei);
      ni[i] = ti[i] - mu * (b[i].x * ei - b[i].y * er);
    }
    return fires;
  };
  // a sample as the reference takes it: the update from the clipped error
  // when the clip fires
  auto exact = [&](const float2 (&b)[kT], float2* yt, int m) {
    float yr, yi, er, ei, nr[kT], ni[kT];
    if (sample(b, yr, yi, er, ei, nr, ni)) {
      const float d = fmaxf(sqrtf(er * er + ei * ei), 1e-12f);
      er = er / d;
      ei = ei / d;
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        nr[i] = tr[i] - mu * (b[i].x * er + b[i].y * ei);
        ni[i] = ti[i] - mu * (b[i].x * ei - b[i].y * er);
      }
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      tr[i] = nr[i];
      ti[i] = ni[i];
    }
    if (lane == 0) yt[m] = make_float2(yr, yi);
  };
  // a sample taken as if its clip does not fire; `fired` collects whether
  // it did
  auto guess = [&](const float2 (&b)[kT], float2* yt, int m, bool& fired) {
    float yr, yi, er, ei;
    fired |= sample(b, yr, yi, er, ei, tr, ti);
    if (lane == 0) yt[m] = make_float2(yr, yi);
    // --- next
  };
  for (long long t = 0; t < tiles; ++t) {
    fetch(t + 1);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    const long long t0 = t * kTile;
    const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                       N - t0));
    const float2* p = sx[t & 1] + kHist - (lane < kQ ? lane : 0);
    float2* yt = y + t0;
    float2 b[kT], nb[kT];                   // this sample's line, the next's
    int m = 0;
    // blocks of kGuess samples taken as if no clip fires, with no branch a
    // sample; a block where one fired (rarely) is taken again exactly
    for (; m + kGuess <= n; m += kGuess) {
      float sr[kT], si[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        sr[i] = tr[i];
        si[i] = ti[i];
      }
      bool fired = false;
      load(b, p + m);
#pragma unroll
      for (int k = 0; k < kGuess; k += 2) {   // the line a sample ahead
        load(nb, p + m + k + 1);
        guess(b, yt, m + k, fired);
        load(b, p + m + k + 2);
        guess(nb, yt, m + k + 1, fired);
      }
      if (__any_sync(kFull, fired)) {
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          tr[i] = sr[i];
          ti[i] = si[i];
        }
        for (int k = 0; k < kGuess; ++k) {
          load(b, p + m + k);
          exact(b, yt, m + k);
        }
      }
    }
    for (; m < n; ++m) {                    // the tile's last samples
      load(b, p + m);
      exact(b, yt, m);
    }
    __syncwarp();                           // the tile's reads done
    if (t + 1 < tiles) {                    // carry its last kHist samples
      sx[(t + 1) & 1][lane] = sx[t & 1][kTile + lane];
      __syncwarp();
    }
  }
  // --- end
#pragma unroll
  for (int i = 0; i < kT; ++i)
    if (on[i]) taps_out[lane + kQ * i] = make_float2(tr[i], ti[i]);
}

template <int P>
int launch(const float2* x, float2* y, long long N, int n_taps,
           const float2* ti, float2* to, float modulus, float mu,
           cudaStream_t st) {
  cma_kernel<P><<<1, 32, 0, st>>>(x, y, N, n_taps, ti, to, modulus, mu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a tap count outside 1 .. 32.
extern "C" int cma_launch(const void* x, void* y, int N, int n_taps,
                          const void* taps_in, void* taps_out, float modulus,
                          float mu, void* stream) {
  if (n_taps < 1 || n_taps > 32 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = static_cast<const float2*>(x);
  auto* ys = static_cast<float2*>(y);
  const auto* ti = static_cast<const float2*>(taps_in);
  auto* to = static_cast<float2*>(taps_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_taps == 1) return launch<1>(xs, ys, N, n_taps, ti, to, modulus, mu, st);
  if (n_taps == 2) return launch<2>(xs, ys, N, n_taps, ti, to, modulus, mu, st);
  if (n_taps <= 4) return launch<4>(xs, ys, N, n_taps, ti, to, modulus, mu, st);
  if (n_taps <= 8) return launch<8>(xs, ys, N, n_taps, ti, to, modulus, mu, st);
  if (n_taps <= 16)
    return launch<16>(xs, ys, N, n_taps, ti, to, modulus, mu, st);
  return launch<32>(xs, ys, N, n_taps, ti, to, modulus, mu, st);
}
