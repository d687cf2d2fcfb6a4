// Steps shared by the DQPSK symbol-recovery kernels (dqpsk.cu, gardner.cu).
//
// Each mirrors one helper of the plain PyTorch loops in
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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace psk {

constexpr int kNSteps = 128;          // interpolator arms - 1
constexpr int kNTaps = 8;
constexpr int kBlock = 32;
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

// Timing and PLL updates (InterpolatingSampleBuffer.resetAndAdjust,
// CostasLoop.adjust) for a channel with a symbol due.
__device__ __forceinline__ void update(float timing_error, float err,
                                       float sp1, float phase, const Loop& k,
                                       float& sp, float& dsps, float& ph,
                                       float& fr) {
  const float detected =
      clip(fma_f64(timing_error, k.dsps_gain, dsps), k.sps_min, k.sps_max);
  const float sp_new = fma_f64(timing_error, k.g, sp1 + detected);
  const float perr = clip(-err, -0.5f, 0.5f);
  float freq = fma_f64(perr, k.beta, fr);
  const float phase2 = wrap(fma_f64(perr, k.alpha, phase + freq));
  freq = clip(freq, -k.max_pll_freq, k.max_pll_freq);
  sp = sp_new;
  dsps = detected;
  ph = phase2;
  fr = freq;
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

}  // namespace psk
