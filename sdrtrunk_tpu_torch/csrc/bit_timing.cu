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
// sums and arg-maxes it on every sample. Here the line is L = ceil(W / 64)
// 64-bit words, newest decision in bit 0 of word 0 (line bit k is the
// decision k samples back; window[i] of the reference layout is line bit
// W - 1 - i), and the kernel is instantiated for every L from 1 to
// kMaxLineWords (W <= 512; L = 1 is the single-word line of W <= 64). The
// vote is a popcount under a mask a word, the crossings are w ^ (w >> 1)
// with the next word's bit 0 carried in at bit 63, under a mask a word
// (crossing i of the reference is line bit zc_len - 2 - i), their count a
// popcount, and the first and last crossing come from clz of the highest
// word that holds one and ffs of the lowest.
//
// What bounds it: each channel's serial chain, not bytes (1023 x 4000
// floats in and the two (C, T) byte planes out move 24.5 MB, 7 us at 3.35
// TB/s). A slicer decision does not depend on the loop's state, so the line
// at any sample is the last W decisions, and the only state carried from
// sample to sample is the counter, which between symbols only runs down by
// one a sample. So the chain has a step a symbol (150 a channel at the LTR
// geometry, 600 at the AFSK one), not a sample. One warp serves a channel,
// kWarps channels a block, in three phases over each tile of kTile samples:
//
// 1. pack (all lanes): the warp reads its row coalesced, and __ballot_sync
//    turns 32 consecutive decisions into a word in shared memory, behind
//    2L words holding the 64 L decisions before the tile (at the first
//    tile the carried window, newest last; after it the last tile's,
//    which lane 0 carries in L registers);
// 2. walk (lane 0): the counter runs down to the next symbol at once (from
//    1 <= sp < 2^23 the per-sample loop's steps are exact subtractions of
//    1, so the symbol falls floor(sp) samples on and leaves sp - floor(sp);
//    any other counter steps as the loop does); there each word of the
//    line comes from three shared words (two funnel shifts and a bit
//    reversal), symbol() takes the step, and the bit and the symbol's
//    place go into two bitmaps;
// 3. write (all lanes): the bitmaps become the whole bits and valid rows,
//    four bytes a lane a store.
//
// Layout: x is (C, T) float32; bits (C, T) int8 and valid (C, T) bool are
// written in full (bits 0 where valid is not set); the state is in the JAX
// reference's layout: window (C, W) int8 (newest last), sampling_point
// (C,) float32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;                 // channels (warps) a block
constexpr int kTile = 8192;               // samples a pass through shared memory
constexpr int kTileWords = kTile / 32;
constexpr int kBatch = 16;                // words whose samples a lane loads at once
constexpr int kMaxLineWords = 8;          // the longest line: W <= 512
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int window_len;
  int zc_len;
  int vote_half;             // majority: votes > vote_len / 2
  int two_crossings;         // FSK rule for exactly two crossings
  int invert;
  // word m of each mask covers line bits 64 m .. 64 m + 63
  uint64_t line_mask[kMaxLineWords];   // the W bits of the delay line
  uint64_t vote_mask[kMaxLineWords];
  uint64_t zc_mask[kMaxLineWords];     // line bits 0 .. zc_len - 2
  float zc_ideal;
  float sps;
  float gain;
};

// The symbol step on the line w (L words): the voted bit and the new
// counter.
template <int L>
__device__ __forceinline__ int8_t symbol(const uint64_t (&w)[L],
                                         const Geometry& g, float& sp) {
  // the votes, the crossings, and the line bits of the oldest and newest
  int votes, count, oldest, newest;
  if constexpr (L == 1) {
    votes = __popcll(w[0] & g.vote_mask[0]);
    const uint64_t cr = (w[0] ^ (w[0] >> 1)) & g.zc_mask[0];
    count = __popcll(cr);
    oldest = 63 - __clzll(static_cast<long long>(cr));
    newest = __ffsll(static_cast<long long>(cr)) - 1;
  } else {
    votes = 0;
    count = 0;
    oldest = -1;
    newest = -1;
#pragma unroll
    for (int m = 0; m < L; ++m) {
      votes += __popcll(w[m] & g.vote_mask[m]);
      const uint64_t carry = m + 1 < L ? w[m + 1] << 63 : 0ull;
      const uint64_t cr = (w[m] ^ ((w[m] >> 1) | carry)) & g.zc_mask[m];
      count += __popcll(cr);
      if (cr != 0ull) {
        oldest = 64 * m + 63 - __clzll(static_cast<long long>(cr));
        if (newest < 0)
          newest = 64 * m + __ffsll(static_cast<long long>(cr)) - 1;
      }
    }
  }
  float error = 0.0f;
  if (count == 1 || (count == 2 && g.two_crossings)) {
    const int first = g.zc_len - 2 - oldest;
    error = (static_cast<float>(first) + 0.5f) - g.zc_ideal;
    if (count == 2) {
      const int last = g.zc_len - 2 - newest;
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

// The packed stream P of a tile: bit b of words[q] is P[32 q + b]; P[64 L +
// t] is the decision of the tile's sample t, P[0 .. 64 L - 1] the 64 L
// before it. Returns P[s .. s + 63], bit b = P[s + b].
__device__ __forceinline__ uint64_t bits64(const uint32_t* words, int s) {
  const int q = s >> 5, r = s & 31;
  const uint32_t lo = __funnelshift_r(words[q], words[q + 1], r);
  const uint32_t hi = __funnelshift_r(words[q + 1], words[q + 2], r);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Bitmap bits 0 .. n - 1 as bytes 0 / 1 at dst[0 .. n), by the warp: single
// bytes up to a 4-byte boundary, a 32-bit store a lane for each four
// samples, single bytes for the rest. bm[n / 32 + 1] must be readable.
__device__ __forceinline__ void expand(const uint32_t* bm, uint8_t* dst, int n,
                                       int lane) {
  const int head = min(
      n, static_cast<int>((4u - (reinterpret_cast<uintptr_t>(dst) & 3u)) & 3u));
  if (lane < head) dst[lane] = (bm[0] >> lane) & 1u;
  const int quads = (n - head) >> 2;
  uint32_t* d4 = reinterpret_cast<uint32_t*>(dst + head);
  for (int k = lane; k < quads; k += 32) {
    const int j = head + 4 * k;
    const uint32_t nib =
        __funnelshift_r(bm[j >> 5], bm[(j >> 5) + 1], j & 31) & 0xFu;
    d4[k] = (nib * 0x00204081u) & 0x01010101u;   // bit i -> byte i
  }
  const int j = head + 4 * quads + lane;
  if (j < n) dst[j] = (bm[j >> 5] >> (j & 31)) & 1u;
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32)
bit_timing_kernel(const float* __restrict__ x, int T, int C, Geometry g,
                  const int8_t* __restrict__ win_in,
                  const float* __restrict__ sp_in, int8_t* __restrict__ bits,
                  uint8_t* __restrict__ valid, int8_t* __restrict__ win_out,
                  float* __restrict__ sp_out) {
  constexpr int kHist = 64 * L;             // decisions kept before a tile
  __shared__ uint32_t s_words[kWarps][kTileWords + 2 * L + 1];
  __shared__ uint32_t s_valid[kWarps][kTileWords + 1];
  __shared__ uint32_t s_bits[kWarps][kTileWords + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;
  uint32_t* words = s_words[warp];
  uint32_t* vmask = s_valid[warp];
  uint32_t* bmask = s_bits[warp];
  const int W = g.window_len;
  const size_t row = static_cast<size_t>(c) * T;

  // the kHist decisions before the first sample: window[i] is bit kHist -
  // W + i, so bit b of 32-bit word q is window[32 q + b - (kHist - W)]
  const int8_t* wr = win_in + static_cast<size_t>(c) * W;
  uint64_t hist[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int i0 = 64 * m + lane - (kHist - W), i1 = i0 + 32;
    const uint32_t lo = __ballot_sync(kFull, i0 >= 0 && i0 < W && wr[i0] != 0);
    const uint32_t hi = __ballot_sync(kFull, i1 >= 0 && i1 < W && wr[i1] != 0);
    hist[m] = (static_cast<uint64_t>(hi) << 32) | lo;
  }
  float sp = sp_in[c];                      // lane 0's is the one carried

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    const int nw = (n + 31) >> 5;
    const float* xr = x + row + t0;
    // --- pack
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < L; ++m) {
        words[2 * m] = static_cast<uint32_t>(hist[m]);
        words[2 * m + 1] = static_cast<uint32_t>(hist[m] >> 32);
      }
      words[nw + 2 * L] = 0;
    }
    for (int k = lane; k <= nw; k += 32) {
      vmask[k] = 0;
      bmask[k] = 0;
    }
    for (int k0 = 0; k0 < nw; k0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = 32 * (k0 + u) + lane;
        v[u] = t < n ? xr[t] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < nw) {
          const int t = 32 * (k0 + u) + lane;
          const uint32_t word = __ballot_sync(
              kFull, t < n && ((v[u] > 0.0f) != (g.invert != 0)));
          if (lane == u) words[2 * L + k0 + u] = word;
        }
      }
    }
    __syncwarp();
    // --- walk
    if (lane == 0) {
      int cur = 0;                          // the bitmap word being filled
      uint32_t cur_v = 0, cur_b = 0;
      int i = 0;                            // samples of the tile stepped
      while (i < n) {
        // run the counter down to the next symbol or the tile's end. From
        // 1 <= sp < 2^23 every step of the per-sample loop subtracts 1
        // exactly, and its symbol comes at step k = floor(sp), leaving sp -
        // k: taken at once, as exact. Any other counter (below 1, huge,
        // NaN) takes one step as the loop takes it.
        if (sp >= 1.0f && sp < 8388608.0f) {
          const int k = static_cast<int>(sp);
          if (k > n - i) {
            sp = sp - static_cast<float>(n - i);
            break;
          }
          sp = sp - static_cast<float>(k);
          i += k;
        } else {
          sp = sp - 1.0f;
          ++i;
          if (!(sp < 1.0f)) continue;
        }
        const int j = i - 1;                // the symbol's sample
        // word m of the line: P[kHist + j - 64 m - 63 .. kHist + j - 64 m],
        // newest in bit 0
        uint64_t w[L];
#pragma unroll
        for (int m = 0; m < L; ++m)
          w[m] = __brevll(bits64(words, kHist - 63 - 64 * m + j)) &
                 g.line_mask[m];
        const int8_t bit = symbol<L>(w, g, sp);
        // the word of the bitmaps being filled, stored after every symbol
        // (no branch); a word no symbol falls in keeps its zero
        const int q = j >> 5;
        const uint32_t m = 1u << (j & 31);
        cur_v = (q == cur ? cur_v : 0u) | m;
        cur_b = (q == cur ? cur_b : 0u) | (bit ? m : 0u);
        cur = q;
        vmask[q] = cur_v;
        bmask[q] = cur_b;
      }
      // the tile's last kHist decisions
#pragma unroll
      for (int m = 0; m < L; ++m) hist[m] = bits64(words, n + 64 * m);
    }
    __syncwarp();
    // --- write
    expand(vmask, valid + row + t0, n, lane);
    expand(bmask, reinterpret_cast<uint8_t*>(bits) + row + t0, n, lane);
    __syncwarp();
  }

  // the new window, window[i] = bit kHist - W + i of lane 0's history,
  // through shared memory (the tiles are done with it)
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < L; ++m) {
      words[2 * m] = static_cast<uint32_t>(hist[m]);
      words[2 * m + 1] = static_cast<uint32_t>(hist[m] >> 32);
    }
  }
  __syncwarp();
  int8_t* wo = win_out + static_cast<size_t>(c) * W;
  for (int i = lane; i < W; i += 32) {
    const int b = kHist - W + i;
    wo[i] = static_cast<int8_t>((words[b >> 5] >> (b & 31)) & 1u);
  }
  if (lane == 0) sp_out[c] = sp;
}

// Line bits lo .. hi - 1 that fall in word m (bits 64 m .. 64 m + 63).
uint64_t span(int m, int lo, int hi) {
  const int a = lo > 64 * m ? lo - 64 * m : 0;
  const int b = hi < 64 * m + 64 ? hi - 64 * m : 64;
  if (a >= b) return 0ull;
  const uint64_t upto = b >= 64 ? ~0ull : (1ull << b) - 1ull;
  return upto & ~((1ull << a) - 1ull);
}

template <int L>
void launch(const float* x, int T, int C, const Geometry& g,
            const int8_t* win_in, const float* sp_in, int8_t* bits,
            uint8_t* valid, int8_t* win_out, float* sp_out,
            cudaStream_t stream) {
  const int grid = (C + kWarps - 1) / kWarps;
  bit_timing_kernel<L><<<grid, kWarps * 32, 0, stream>>>(
      x, T, C, g, win_in, sp_in, bits, valid, win_out, sp_out);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a geometry the line cannot hold
// (2 <= zc_len <= W <= 64 * kMaxLineWords = 512, the vote window inside
// the line).
extern "C" int bit_timing_launch(
    const void* x, int T, int C, int W, int vote_start, int vote_len,
    int zc_len, int two_crossings, int invert, const void* win_in,
    const void* sp_in, void* bits, void* valid, void* win_out, void* sp_out,
    float zc_ideal, float sps, float gain, void* stream) {
  if (C <= 0) return 0;
  if (W > 64 * kMaxLineWords || zc_len < 2 || zc_len > W || vote_start < 0 ||
      vote_len < 1 || vote_start + vote_len > W || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.window_len = W;
  g.zc_len = zc_len;
  g.vote_half = vote_len / 2;
  g.two_crossings = two_crossings;
  g.invert = invert;
  for (int m = 0; m < kMaxLineWords; ++m) {
    g.line_mask[m] = span(m, 0, W);
    // window[vote_start .. vote_start + vote_len) = line bits W -
    // vote_start - vote_len .. W - 1 - vote_start
    g.vote_mask[m] = span(m, W - vote_start - vote_len, W - vote_start);
    g.zc_mask[m] = span(m, 0, zc_len - 1);
  }
  g.zc_ideal = zc_ideal;
  g.sps = sps;
  g.gain = gain;
  const auto* xs = static_cast<const float*>(x);
  const auto* wi = static_cast<const int8_t*>(win_in);
  const auto* si = static_cast<const float*>(sp_in);
  auto* b = static_cast<int8_t*>(bits);
  auto* v = static_cast<uint8_t*>(valid);
  auto* wo = static_cast<int8_t*>(win_out);
  auto* so = static_cast<float*>(sp_out);
  auto* st = static_cast<cudaStream_t>(stream);
  switch ((W + 63) / 64) {                  // L, the line's words
    case 1: launch<1>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
    case 2: launch<2>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
    case 3: launch<3>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
    case 4: launch<4>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
    case 5: launch<5>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
    case 6: launch<6>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
    case 7: launch<7>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
    default: launch<8>(xs, T, C, g, wi, si, b, v, wo, so, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
