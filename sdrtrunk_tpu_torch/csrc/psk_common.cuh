// Steps and the loop skeleton shared by the DQPSK symbol-recovery kernels
// (dqpsk.cu, gardner.cu).
//
// Each step mirrors one helper of the plain PyTorch loops in
// sdrtrunk_tpu_torch/dsp/psk.py (class _Loop), operation for operation, so
// that with --fmad=false each kernel and its plain loop agree bit for bit.
//
// Numerics (build with --fmad=false, no fast math):
// * constants arrive as float, so every compare and product is float32;
// * XLA:CPU contracts the reference's a*b+c into fused multiply-adds;
//   fma_f64 gives the same single rounding (the float64 product of two
//   floats is exact), and matches the plain loops' float64 ops;
// * cos, sin and rsqrt are taken in double and rounded to float;
// * clips are written as compares so that NaN passes through them as in
//   jnp.clip, then the error's NaN is zeroed as the reference does;
// * the frequency clamp follows the phase update that used the
//   unclamped frequency (psk.py:245-247, :483-485).
//
// The loop (symbol_loop) is symbol-major. The per-sample recurrence only
// changes sp -= 1 and ph = wrap(ph + fr) between symbols, and fr is fixed
// there, so the run of samples up to the next symbol is known from two
// cheap float chains: its length n (sp iterated down to < 1, exactly as the
// per-sample loop does) and its n phases. The run's n mixes (float64
// cos/sin, the costly part of a sample) do not depend on each other: G
// lanes serve one channel and each mixes K of them, so a run costs about
// one mix's latency, not n. Every lane of the group then takes the symbol
// step on identical state, so no lane has to broadcast it. A warp's groups
// all take one symbol per pass, so the symbol path no longer runs at
// nearly every sample, as it did when the 32 lanes of a warp were 32
// channels at independent symbol phases.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace psk {

constexpr int kNSteps = 128;          // interpolator arms - 1
constexpr int kNTaps = 8;
constexpr int kBlock = 32;            // one warp a block: blocks spread over SMs
// the window lengths W = floor(2 * samples/symbol) the kernels take: from
// the reference's least, 4 samples a symbol, to 64 samples a symbol (a
// 192 kHz capture at 4800 Bd gives W = 80)
constexpr int kMinWindow = 8;
constexpr int kMaxWindow = 128;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kSqrtHalf = 0.70710678118654752440f;

struct Loop {
  float sps_min, sps_max, g, dsps_gain, alpha, beta, max_pll_freq;
};

__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);   // NaN passes, as jnp.clip
}

__device__ __forceinline__ float wrap(float p) {
  p = p > kTwoPi ? p - kTwoPi : p;
  return p < -kTwoPi ? p + kTwoPi : p;
}

// Sample x de-rotated by the PLL phase (PSKDemodulator.java:101-110).
__device__ __forceinline__ float2 mix(float2 x, float phase) {
  const float cos_p = static_cast<float>(cos(static_cast<double>(phase)));
  const float sin_p = static_cast<float>(sin(static_cast<double>(phase)));
  return make_float2(fma_f64(x.x, cos_p, -(x.y * sin_p)),
                     fma_f64(x.y, cos_p, x.x * sin_p));
}

// normalize(p * conj(q)) with the reference's zero-safe guard.
__device__ __forceinline__ float2 diff_norm(float2 p, float2 q) {
  const float re = fma_f64(p.x, q.x, p.y * q.y);
  const float im = fma_f64(-p.x, q.y, p.y * q.x);
  const float m2 = fma_f64(re, re, im * im);
  const float inv = static_cast<float>(
      1.0 / sqrt(static_cast<double>(m2 < 1e-30f ? 1e-30f : m2)));
  return m2 > 1e-24f ? make_float2(re * inv, im * inv)
                     : make_float2(0.0f, 0.0f);
}

// 8-tap interpolation: the first product rounded, then 7 fused
// multiply-adds left to right over w[0..7].
__device__ __forceinline__ float interp8(const float* taps, const float* w) {
  float acc = taps[0] * w[0];
#pragma unroll
  for (int j = 1; j < kNTaps; ++j) acc = fma_f64(taps[j], w[j], acc);
  return acc;
}

// Quadrant decision of a normalized symbol (DQPSKDecisionDirected-
// SymbolEvaluator): the packed byte `dibit | 4` and the de-rotated
// quadrature error clipped to +/-0.3 with NaN zeroed.
struct Decision {
  bool i_pos;
  uint8_t byte;
  float err;
};

__device__ __forceinline__ Decision decide(float cin, float cqn) {
  const bool i_pos = cin > 0.0f, q_pos = cqn > 0.0f;
  const int dibit = (q_pos ? 0 : 2) + (i_pos ? 0 : 1);
  const float sgn_i = i_pos ? 1.0f : -1.0f;
  const float sgn_q = q_pos ? 1.0f : -1.0f;
  float err = clip(kSqrtHalf * (cqn * sgn_i - cin * sgn_q), -0.3f, 0.3f);
  if (isnan(err)) err = 0.0f;
  return {i_pos, static_cast<uint8_t>(dibit | 4), err};
}

// A channel's carried timing and PLL scalars.
struct Timing {
  float sp, dsps, ph, fr;
};

// Timing and PLL updates (InterpolatingSampleBuffer.resetAndAdjust,
// CostasLoop.adjust) for a channel with a symbol due.
__device__ __forceinline__ void update(float timing_error, float err,
                                       float sp1, float phase, const Loop& k,
                                       Timing& tm) {
  const float detected =
      clip(fma_f64(timing_error, k.dsps_gain, tm.dsps), k.sps_min, k.sps_max);
  const float sp_new = fma_f64(timing_error, k.g, sp1 + detected);
  const float perr = clip(-err, -0.5f, 0.5f);
  float freq = fma_f64(perr, k.beta, tm.fr);
  const float phase2 = wrap(fma_f64(perr, k.alpha, phase + freq));
  freq = clip(freq, -k.max_pll_freq, k.max_pll_freq);
  tm.sp = sp_new;
  tm.dsps = detected;
  tm.ph = phase2;
  tm.fr = freq;
}

// Copies the 129 x 8 interpolator bank into shared memory.
__device__ __forceinline__ void load_bank(float* bank, const float* bank_g) {
  for (int i = threadIdx.x; i < (kNSteps + 1) * kNTaps; i += blockDim.x) {
    bank[i] = bank_g[i];
  }
  __syncthreads();
}

// The arm of a fractional offset in [0, 1]: (int)(128 * mu) in [0, 128].
__device__ __forceinline__ int arm(float mu) {
  const int idx = static_cast<int>(mu * static_cast<float>(kNSteps));
  return idx < 0 ? 0 : (idx > kNSteps ? kNSteps : idx);
}

// A channel's delay line: a ring of `size` samples (a power of two, at
// least W and at least a pass's G*K; ring_size) in shared memory, re and
// im in rows of size + 1 words, so that the rows of a warp's channels fall
// on different banks. `head` counts the samples pushed; the W-sample window
// (oldest first) is the W samples before it. A pass writes its samples
// over ones older than the window, so size >= W and size >= G*K suffice.
struct Ring {
  float* re;
  float* im;
  int head;
  int w;
  int mask;                                               // size - 1

  __device__ __forceinline__ float2 at(int j) const {     // window[j]
    const int i = (head - w + j) & mask;
    return make_float2(re[i], im[i]);
  }
  __device__ __forceinline__ void put(int j, float2 v) {  // sample head + j
    const int i = (head + j) & mask;
    re[i] = v.x;
    im[i] = v.y;
  }
};

// The smallest power of two that is at least W and at least a pass.
inline int ring_size(int W, int pass) {
  int size = 1;
  while (size < W || size < pass) size *= 2;
  return size;
}

// The lane layout of a launch: G lanes serve a channel, each mixing K
// samples of a pass.
template <int G_, int K_>
struct Lanes {
  static constexpr int G = G_;
  static constexpr int K = K_;
};

// Calls launch(Lanes<G, K>{}) with the layout for window length W, then
// returns cudaGetLastError(); cudaErrorInvalidValue for a W outside
// [kMinWindow, kMaxWindow]. The rule: a pass of G*K samples should cover
// one run, about W/2 samples (the samples a symbol), so that a run costs
// one mix's latency: 8 lanes to W = 12 (runs of up to 7), 16 to W = 31
// (16), a warp to W = 63 (32), and a warp of two mixes each above (64).
// A pass shorter than a run is still exact (symbol_loop carries the run
// on in the next pass), so the rule only sets the speed.
template <class Launch>
int with_lanes(int W, Launch&& launch) {
  if (W < kMinWindow || W > kMaxWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (W <= 12) {
    launch(Lanes<8, 1>{});
  } else if (W <= 31) {
    launch(Lanes<16, 1>{});
  } else if (W <= 63) {
    launch(Lanes<32, 1>{});
  } else {
    launch(Lanes<32, 2>{});
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block's rings: kBlock / G groups, each a re
// and an im row of size + 1 words.
inline size_t ring_bytes(int groups, int size) {
  return sizeof(float) * 2 * static_cast<size_t>(groups) * (size + 1);
}

// The lanes of the calling thread's group of G in its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    const int first = (threadIdx.x & 31) / G * G;
    return ((1u << G) - 1u) << first;
  }
}

// The ring of a window read from the (C, W) state row into group
// `group`'s rows of `rings` (kBlock / G groups), lane `lane` of G copying
// entries lane, lane + G, ...
template <int G>
__device__ __forceinline__ Ring load_ring(float* rings, int size, int group,
                                          const float2* win, int W, int lane,
                                          unsigned gmask) {
  constexpr int kGroups = kBlock / G;
  Ring r{rings + group * (size + 1), rings + (kGroups + group) * (size + 1),
         W, W, size - 1};
  for (int j = lane; j < W; j += G) r.put(j - W, win[j]);
  __syncwarp(gmask);
  return r;
}

template <int G>
__device__ __forceinline__ void store_ring(const Ring& r, float2* win,
                                           int lane) {
  for (int j = lane; j < r.w; j += G) win[j] = r.at(j);
}

// The samples a lane mixes in the pass that starts at sample t.
template <int G, int K>
__device__ __forceinline__ void load_pass(const float2* __restrict__ xc,
                                          int t, int T, int lane,
                                          float2 (&xb)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + lane + G * k;
    xb[k] = i < T ? xc[i] : make_float2(0.0f, 0.0f);
  }
}

// One channel's loop over its T samples xc (a row of the (C, T) stream),
// in passes of up to G*K samples, each ending at a symbol, at G*K samples
// or at T. G lanes serve the channel; lane `lane` mixes samples lane,
// lane + G, ... of each pass. Every lane runs each symbol step, `step(ring,
// sp1, phase, tm)`, which returns the packed byte; lane 0 writes it at the
// symbol's sample of out_c (a column of the (T, C) output, stride C). The
// pass stops at T exactly where the per-sample loop would, so carried
// state is per-sample exact across calls; out_c is written only at
// symbols (the caller zero-fills it).
template <int G, int K, class Step>
__device__ __forceinline__ void symbol_loop(const float2* __restrict__ xc,
                                            int T, Ring& ring, int lane,
                                            unsigned gmask, Timing& tm,
                                            Step& step,
                                            uint8_t* __restrict__ out_c,
                                            int C) {
  float2 xb[K];
  load_pass<G, K>(xc, 0, T, lane, xb);
  int t = 0;
  while (t < T) {
    // --- the run: its length n and its phases, as the per-sample loop ---
    float phs[K] = {};
    float sp = tm.sp, ph = tm.ph, sp1 = 0.0f, phase = 0.0f;
    int n = 0;
    bool due = false;
#pragma unroll
    for (int i = 0; i < G * K; ++i) {
      if (due || t + i >= T) break;
      phase = wrap(ph + tm.fr);
      sp1 = sp - 1.0f;
      if (i % G == lane) phs[i / G] = phase;
      n = i + 1;
      due = sp1 < 1.0f;
      if (!due) {
        sp = sp1;
        ph = phase;
      }
    }
    // --- its mixes, K per lane, independent of each other ---
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + G * k < n) ring.put(lane + G * k, mix(xb[k], phs[k]));
    }
    __syncwarp(gmask);
    ring.head += n;
    t += n;
    load_pass<G, K>(xc, t, T, lane, xb);      // in flight during the step
    if (due) {
      const uint8_t o = step(ring, sp1, phase, tm);
      if (lane == 0) out_c[static_cast<size_t>(t - 1) * C] = o;
      __syncwarp(gmask);                      // reads done before the pass
    } else {
      tm.sp = sp;
      tm.ph = ph;
    }
  }
}

}  // namespace psk
