// Gardner-timed DQPSK symbol recovery for Hopper (sm_90a): P25 LSM and
// P25 Phase 2 HDQPSK.
//
// Replaces sdrtrunk_tpu/dsp/pallas_gardner.py::_gardner_kernel (the Pallas
// TPU kernel behind GardnerDQPSKDemodulator.batched). Its plain PyTorch
// version is sdrtrunk_tpu_torch/dsp/psk.py::GardnerDQPSKDemodulator
// .scan_packed; the two use the same operations in the same order
// (psk_common.cuh), so on the card they agree bit for bit.
//
// Per sample: PLL mix and delay-line shift; then, where a symbol is due,
// two 8-tap interpolations, the Gardner mid point at mu = clip(sp, 0, 1)
// and the symbol point at detected_sps / 2, each at its own integer base
// into the window; each point differentially decoded against its own
// previous raw sample and normalized; the Gardner error (prev - cur) . mid
// clipped to +/-0.3 drives timing, the quadrant decision's de-rotated
// quadrature drives the PLL.
//
// What bounds it: per-sample serial latency, as in dqpsk.cu, whose layout
// it keeps: one thread per channel, the W-sample delay line and the ten
// scalars in registers, the 129x8 bank in shared memory, (T, C) float2
// input read coalesced and loaded one step ahead, (T, C) uint8 output,
// 32-thread blocks, channels masked with c < C. The integer base of each
// point varies per channel at run time; indexing the register window with
// it would push the window to local memory, so the fetch is unrolled over
// every base 0..W-8 with a compile-time index and a select, and reads only
// where the base lies in the point's feasible range [lo, hi] (the
// reference's static base sets, GardnerDQPSKDemodulator.mid_bases /
// cur_bases); the point is 0 otherwise, as in the reference.
//
// Layout: out is `dibit | valid << 2` (0 where no symbol is due). State is
// in the JAX reference's layout: window (C, W) complex64, four (C,) float32
// leaves and three (C,) complex64 leaves.
#include "psk_common.cuh"

namespace {

using namespace psk;

struct State {
  const float2* win;    // (C, W)
  const float* sp;
  const float* dsps;
  const float* ph;
  const float* fr;
  const float2* pm;     // prev_mid_sample
  const float2* pc;     // prev_cur_sample
  const float2* ps;     // prev_cur_symbol
};

struct StateOut {
  float2* win;
  float* sp;
  float* dsps;
  float* ph;
  float* fr;
  float2* pm;
  float2* pc;
  float2* ps;
};

struct Bases {
  int mid_lo, mid_hi, cur_lo, cur_hi;
};

// 8-tap interpolation at a fractional offset into the window: the integer
// part picks the base (clipped to [0, W-8], read only inside [lo, hi]),
// the fraction the arm.
template <int W>
__device__ __forceinline__ float2 interp_at(const float (&wr)[W],
                                            const float (&wi)[W],
                                            const float* bank, float offset,
                                            int lo, int hi) {
  const float k = floorf(offset);
  const float* taps = bank + arm(offset - k) * kNTaps;
  int base = static_cast<int>(k);
  base = base < 0 ? 0 : (base > W - 8 ? W - 8 : base);
  float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int b = 0; b <= W - 8; ++b) {
    if (b == base && b >= lo && b <= hi) {
      s = make_float2(interp8(taps, wr + b), interp8(taps, wi + b));
    }
  }
  return s;
}

template <int W>
__global__ void __launch_bounds__(kBlock)
gardner_kernel(const float2* __restrict__ x, int T, int C,
               const float* __restrict__ bank_g, State in, StateOut st,
               uint8_t* __restrict__ out, Loop k, Bases bs) {
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
  float2 pm = in.pm[c], pc = in.pc[c], ps = in.ps[c];

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
      // --- the two points, each decoded against its previous sample ---
      const float2 mid = interp_at<W>(wr, wi, bank, clip(sp1, 0.0f, 1.0f),
                                      bs.mid_lo, bs.mid_hi);
      const float2 cur = interp_at<W>(wr, wi, bank, dsps * 0.5f,
                                      bs.cur_lo, bs.cur_hi);
      const float2 ms = diff_norm(mid, pm);
      const float2 cs = diff_norm(cur, pc);

      // --- Gardner TED (DQPSKGardnerSymbolEvaluator.setSymbols) ---
      const float d_re = ps.x - cs.x, d_im = ps.y - cs.y;
      float terr = fma_f64(d_re, ms.x, d_im * ms.y);
      if (isnan(terr)) terr = 0.0f;
      terr = clip(terr, -0.3f, 0.3f);

      const Decision d = decide(cs.x, cs.y);
      o = d.byte;
      update(terr, d.err, sp1, phase, k, sp, dsps, ph, fr);
      pm = mid;
      pc = cur;
      ps = cs;
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
  st.pm[c] = pm;
  st.pc[c] = pc;
  st.ps[c] = ps;
}

template <int W>
void launch(const float2* x, int T, int C, const float* bank, State in,
            StateOut st, uint8_t* out, Loop k, Bases bs,
            cudaStream_t stream) {
  const int grid = (C + kBlock - 1) / kBlock;
  gardner_kernel<W><<<grid, kBlock, 0, stream>>>(x, T, C, bank, in, st, out,
                                                 k, bs);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a window length without an
// instantiation: W = 11 (LSM at 25 kHz, or 6000 Bd at 25 kHz) and W = 16
// (P25 Phase 2 at 50 kHz).
extern "C" int gardner_launch(
    const void* x, int T, int C, int W, const void* bank,
    const void* win_in, const void* sp_in, const void* dsps_in,
    const void* ph_in, const void* fr_in, const void* pm_in,
    const void* pc_in, const void* ps_in, void* out, void* win_out,
    void* sp_out, void* dsps_out, void* ph_out, void* fr_out, void* pm_out,
    void* pc_out, void* ps_out, float sps_min, float sps_max, float g,
    float dsps_gain, float alpha, float beta, float max_pll_freq,
    int mid_lo, int mid_hi, int cur_lo, int cur_hi, void* stream) {
  if (C <= 0) return 0;
  const State in{static_cast<const float2*>(win_in),
                 static_cast<const float*>(sp_in),
                 static_cast<const float*>(dsps_in),
                 static_cast<const float*>(ph_in),
                 static_cast<const float*>(fr_in),
                 static_cast<const float2*>(pm_in),
                 static_cast<const float2*>(pc_in),
                 static_cast<const float2*>(ps_in)};
  const StateOut st{static_cast<float2*>(win_out), static_cast<float*>(sp_out),
                    static_cast<float*>(dsps_out), static_cast<float*>(ph_out),
                    static_cast<float*>(fr_out), static_cast<float2*>(pm_out),
                    static_cast<float2*>(pc_out), static_cast<float2*>(ps_out)};
  const Loop k{sps_min, sps_max, g, dsps_gain, alpha, beta, max_pll_freq};
  const Bases bs{mid_lo, mid_hi, cur_lo, cur_hi};
  const auto* xp = static_cast<const float2*>(x);
  const auto* bp = static_cast<const float*>(bank);
  auto* op = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 11: launch<11>(xp, T, C, bp, in, st, op, k, bs, s); break;
    case 16: launch<16>(xp, T, C, bp, in, st, op, k, bs, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
