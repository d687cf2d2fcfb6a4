// Decision-directed DQPSK symbol recovery for Hopper (sm_90a).
//
// Replaces sdrtrunk_tpu/dsp/pallas_psk.py::_dqpsk_kernel (the Pallas TPU
// kernel behind DQPSKDemodulator.batched). Its plain PyTorch version is
// sdrtrunk_tpu_torch/dsp/psk.py::DQPSKDemodulator.scan_packed; the two
// use the same operations in the same order (psk_common.cuh), so on the
// card they agree bit for bit.
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
#include "psk_common.cuh"

namespace {

using namespace psk;

constexpr int kCenter = 3;            // preceding sample = window[3]

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

template <int W>
__global__ void __launch_bounds__(kBlock)
dqpsk_kernel(const float2* __restrict__ x, int T, int C,
             const float* __restrict__ bank_g, State in, StateOut st,
             uint8_t* __restrict__ out, Loop k) {
  __shared__ float bank[(kNSteps + 1) * kNTaps];
  load_bank(bank, bank_g);
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
  float2 pp = in.pp[c], pc = in.pc[c];

  float2 xn = T > 0 ? x[c] : make_float2(0.f, 0.f);
  for (int t = 0; t < T; ++t) {
    const float2 xv = xn;
    if (t + 1 < T) xn = x[static_cast<size_t>(t + 1) * C + c];

    const float phase = wrap(ph + fr);
    const float2 m = mix(xv, phase);
#pragma unroll
    for (int j = 0; j < W - 1; ++j) {
      wr[j] = wr[j + 1];
      wi[j] = wi[j + 1];
    }
    wr[W - 1] = m.x;
    wi[W - 1] = m.y;
    const float sp1 = sp - 1.0f;
    uint8_t o = 0;
    if (sp1 < 1.0f) {
      // --- interpolate at mu: arm by index, 8 taps left to right ---
      const float* taps = bank + arm(clip(sp1, 0.0f, 1.0f)) * kNTaps;
      const float2 cur = make_float2(interp8(taps, wr), interp8(taps, wi));
      const float2 prec = make_float2(wr[kCenter], wi[kCenter]);

      // --- differential decode + normalize, quadrant decision ---
      const float pqn = diff_norm(prec, pp).y;
      const float2 cn = diff_norm(cur, pc);
      const Decision d = decide(cn.x, cn.y);
      o = d.byte;
      const float polarity =
          (d.i_pos ? (pqn > cn.y) : (pqn < cn.y)) ? 1.0f : -1.0f;
      update(d.err * polarity, d.err, sp1, phase, k, sp, dsps, ph, fr);
      pp = prec;
      pc = cur;
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
  st.pp[c] = pp;
  st.pc[c] = pc;
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
