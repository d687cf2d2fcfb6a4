// Decision-directed DQPSK symbol recovery for Hopper (sm_90a).
//
// Replaces sdrtrunk_tpu/dsp/pallas_psk.py::_dqpsk_kernel (the Pallas TPU
// kernel behind DQPSKDemodulator.batched). Its plain PyTorch version is
// sdrtrunk_tpu_torch/dsp/psk.py::DQPSKDemodulator.scan_packed; the two
// use the same operations in the same order, so on the card they agree
// bit for bit.
//
// What bounds it: per-sample serial latency, not bytes. Each channel is a
// feedback loop that must finish sample t before it can start t+1; at the
// live bank's 1023 channels one thread per channel gives 32 warps on 132
// SMs, so each SM issues one dependent chain and nothing hides its
// latency. The design keeps that chain short and everything it touches
// close: the delay line and the eight scalars live in registers, the
// 129x8 interpolator bank in shared memory (lanes read different arms, so
// __constant__ would serialize), the next input sample is loaded one
// iteration ahead, and 32-thread blocks spread the warps over 32 SMs.
//
// Layout: x is the (T, C) complex64 stream read as float2 at [t*C + c], so
// neighbouring threads read neighbouring addresses; out is (T, C) uint8
// `dibit | valid << 2` (0 where no symbol is due). State is in the JAX
// reference's layout: window (C, W) complex64, six (C,) leaves.
//
// Numerics (build with --fmad=false, no fast math):
// * constants arrive as float, so every compare and product is float32;
// * XLA:CPU contracts the reference's a*b+c into fused multiply-adds;
//   fma_f64 gives the same single rounding (the float64 product of two
//   floats is exact), and matches the plain version's float64 ops;
// * cos, sin and rsqrt are taken in double and rounded to float;
// * clips are written as compares so that NaN passes through them as in
//   jnp.clip, then the error's NaN is zeroed as the reference does;
// * the frequency clamp follows the phase update that used the
//   unclamped frequency (psk.py:245-247).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNSteps = 128;          // interpolator arms - 1
constexpr int kNTaps = 8;
constexpr int kCenter = 3;            // preceding sample = window[3]
constexpr int kBlock = 32;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kSqrtHalf = 0.70710678118654752440f;

struct Loop {
  float sps_min, sps_max, g, dsps_gain, alpha, beta, max_pll_freq;
};

struct State {
  const float2* win;    // (C, W)
  const float* sp;
  const float* dsps;
  const float* ph;
  const float* fr;
  const float2* pp;     // prev_preceding
  const float2* pc;     // prev_current
};

struct StateOut {
  float2* win;
  float* sp;
  float* dsps;
  float* ph;
  float* fr;
  float2* pp;
  float2* pc;
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

template <int W>
__global__ void __launch_bounds__(kBlock)
dqpsk_kernel(const float2* __restrict__ x, int T, int C,
             const float* __restrict__ bank_g, State in, StateOut st,
             uint8_t* __restrict__ out, Loop k) {
  __shared__ float bank[(kNSteps + 1) * kNTaps];
  for (int i = threadIdx.x; i < (kNSteps + 1) * kNTaps; i += blockDim.x) {
    bank[i] = bank_g[i];
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  float wr[W], wi[W];                 // delay line, oldest first
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float2 v = in.win[static_cast<size_t>(c) * W + j];
    wr[j] = v.x;
    wi[j] = v.y;
  }
  float sp = in.sp[c], dsps = in.dsps[c], ph = in.ph[c], fr = in.fr[c];
  float pp_re = in.pp[c].x, pp_im = in.pp[c].y;
  float pc_re = in.pc[c].x, pc_im = in.pc[c].y;

  float2 xn = T > 0 ? x[c] : make_float2(0.f, 0.f);
  for (int t = 0; t < T; ++t) {
    const float2 xv = xn;
    if (t + 1 < T) xn = x[static_cast<size_t>(t + 1) * C + c];

    // --- PLL increment + mix (PSKDemodulator.java:101-110) ---
    const float phase = wrap(ph + fr);
    const float cos_p = static_cast<float>(cos(static_cast<double>(phase)));
    const float sin_p = static_cast<float>(sin(static_cast<double>(phase)));
    const float mr = fma_f64(xv.x, cos_p, -(xv.y * sin_p));
    const float mi = fma_f64(xv.y, cos_p, xv.x * sin_p);
#pragma unroll
    for (int j = 0; j < W - 1; ++j) {
      wr[j] = wr[j + 1];
      wi[j] = wi[j + 1];
    }
    wr[W - 1] = mr;
    wi[W - 1] = mi;
    const float sp1 = sp - 1.0f;
    uint8_t o = 0;
    if (sp1 < 1.0f) {
      // --- interpolate at mu: arm by index, 8 taps left to right ---
      const float mu = clip(sp1, 0.0f, 1.0f);
      int idx = static_cast<int>(mu * static_cast<float>(kNSteps));
      idx = idx < 0 ? 0 : (idx > kNSteps ? kNSteps : idx);
      const float* taps = bank + idx * kNTaps;
      float cur_re = taps[0] * wr[0];
      float cur_im = taps[0] * wi[0];
#pragma unroll
      for (int j = 1; j < kNTaps; ++j) {
        cur_re = fma_f64(taps[j], wr[j], cur_re);
        cur_im = fma_f64(taps[j], wi[j], cur_im);
      }
      const float prec_re = wr[kCenter], prec_im = wi[kCenter];

      // --- differential decode + normalize ---
      const float pr = fma_f64(prec_re, pp_re, prec_im * pp_im);
      const float pi_ = fma_f64(-prec_re, pp_im, prec_im * pp_re);
      const float cr = fma_f64(cur_re, pc_re, cur_im * pc_im);
      const float ci_ = fma_f64(-cur_re, pc_im, cur_im * pc_re);
      const float pm2 = fma_f64(pr, pr, pi_ * pi_);
      const float cm2 = fma_f64(cr, cr, ci_ * ci_);
      const float inv_p = static_cast<float>(
          1.0 / sqrt(static_cast<double>(pm2 < 1e-30f ? 1e-30f : pm2)));
      const float inv_c = static_cast<float>(
          1.0 / sqrt(static_cast<double>(cm2 < 1e-30f ? 1e-30f : cm2)));
      const float pqn = pm2 > 1e-24f ? pi_ * inv_p : 0.0f;
      const float cin = cm2 > 1e-24f ? cr * inv_c : 0.0f;
      const float cqn = cm2 > 1e-24f ? ci_ * inv_c : 0.0f;

      // --- quadrant decision + errors (DQPSKDecisionDirectedSymbolEvaluator)
      const bool i_pos = cin > 0.0f, q_pos = cqn > 0.0f;
      const int dibit = (q_pos ? 0 : 2) + (i_pos ? 0 : 1);
      o = static_cast<uint8_t>(dibit | 4);
      const float polarity =
          (i_pos ? (pqn > cqn) : (pqn < cqn)) ? 1.0f : -1.0f;
      const float sgn_i = i_pos ? 1.0f : -1.0f;
      const float sgn_q = q_pos ? 1.0f : -1.0f;
      float err = clip(kSqrtHalf * (cqn * sgn_i - cin * sgn_q), -0.3f, 0.3f);
      if (isnan(err)) err = 0.0f;
      const float timing_error = err * polarity;

      // --- timing + PLL updates (resetAndAdjust / CostasLoop.adjust) ---
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
      pp_re = prec_re;
      pp_im = prec_im;
      pc_re = cur_re;
      pc_im = cur_im;
    } else {
      sp = sp1;
      ph = phase;
    }
    out[static_cast<size_t>(t) * C + c] = o;
  }

#pragma unroll
  for (int j = 0; j < W; ++j) {
    st.win[static_cast<size_t>(c) * W + j] = make_float2(wr[j], wi[j]);
  }
  st.sp[c] = sp;
  st.dsps[c] = dsps;
  st.ph[c] = ph;
  st.fr[c] = fr;
  st.pp[c] = make_float2(pp_re, pp_im);
  st.pc[c] = make_float2(pc_re, pc_im);
}

template <int W>
void launch(const float2* x, int T, int C, const float* bank, State in,
            StateOut st, uint8_t* out, Loop k, cudaStream_t stream) {
  const int grid = (C + kBlock - 1) / kBlock;
  dqpsk_kernel<W><<<grid, kBlock, 0, stream>>>(x, T, C, bank, in, st, out, k);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a window length without an
// instantiation (W = floor(2 * samples/symbol); 10 at 25 kHz / 4800 Bd).
extern "C" int dqpsk_launch(
    const void* x, int T, int C, int W, const void* bank,
    const void* win_in, const void* sp_in, const void* dsps_in,
    const void* ph_in, const void* fr_in, const void* pp_in,
    const void* pc_in, void* out, void* win_out, void* sp_out,
    void* dsps_out, void* ph_out, void* fr_out, void* pp_out, void* pc_out,
    float sps_min, float sps_max, float g, float dsps_gain, float alpha,
    float beta, float max_pll_freq, void* stream) {
  if (C <= 0) return 0;
  const State in{static_cast<const float2*>(win_in),
                 static_cast<const float*>(sp_in),
                 static_cast<const float*>(dsps_in),
                 static_cast<const float*>(ph_in),
                 static_cast<const float*>(fr_in),
                 static_cast<const float2*>(pp_in),
                 static_cast<const float2*>(pc_in)};
  const StateOut st{static_cast<float2*>(win_out), static_cast<float*>(sp_out),
                    static_cast<float*>(dsps_out), static_cast<float*>(ph_out),
                    static_cast<float*>(fr_out), static_cast<float2*>(pp_out),
                    static_cast<float2*>(pc_out)};
  const Loop k{sps_min, sps_max, g, dsps_gain, alpha, beta, max_pll_freq};
  const auto* xp = static_cast<const float2*>(x);
  const auto* bp = static_cast<const float*>(bank);
  auto* op = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8: launch<8>(xp, T, C, bp, in, st, op, k, s); break;
    case 9: launch<9>(xp, T, C, bp, in, st, op, k, s); break;
    case 10: launch<10>(xp, T, C, bp, in, st, op, k, s); break;
    case 11: launch<11>(xp, T, C, bp, in, st, op, k, s); break;
    case 12: launch<12>(xp, T, C, bp, in, st, op, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
