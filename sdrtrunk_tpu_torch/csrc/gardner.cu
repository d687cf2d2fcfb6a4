// Gardner-timed DQPSK symbol recovery for Hopper (sm_90a): P25 LSM and
// P25 Phase 2 HDQPSK.
//
// Replaces sdrtrunk_tpu/dsp/pallas_gardner.py::_gardner_kernel (the Pallas
// TPU kernel behind GardnerDQPSKDemodulator.batched). Its plain PyTorch
// version is sdrtrunk_tpu_torch/dsp/psk.py::GardnerDQPSKDemodulator
// .scan_packed; the two use the same operations in the same order
// (psk_common.cuh), so on the card they agree bit for bit.
//
// Per sample: PLL mix into the delay line; then, where a symbol is due,
// two 8-tap interpolations, the Gardner mid point at mu = clip(sp, 0, 1)
// and the symbol point at detected_sps / 2, each at its own integer base
// into the window; each point differentially decoded against its own
// previous raw sample and normalized; the Gardner error (prev - cur) . mid
// clipped to +/-0.3 drives timing, the quadrant decision's de-rotated
// quadrature drives the PLL.
//
// What bounds it: each channel's serial chain, not bytes (1023 x 20480
// samples move 189 MB, 56 us at 3.35 TB/s). Per symbol the chain is the
// run's mixes (float64 cos/sin) and the symbol step (two interpolations,
// two float64 normalizations, the updates). The design (psk_common.cuh's
// symbol_loop) takes the symbol path once per symbol, not at nearly every
// sample of a warp; spreads a run's mixes over G lanes, so a run costs one
// mix's latency; and puts G x 1023 threads on the card's SMs instead of 32
// warps on 32 of them. The delay line is a ring in shared memory, so each
// point is one 8-tap read at its computed base (clipped to [0, W-8]; the
// point is 0 where the base lies outside the reference's static base set
// [lo, hi], GardnerDQPSKDemodulator.mid_bases / cur_bases), where the
// register window needed a guarded read at every possible base. Each
// channel reads its own row of the (C, T) stream, a pass's samples loaded
// during the symbol step before it.
//
// Layout: x is (C, T) complex64; out is (T, C) uint8 `dibit | valid << 2`,
// written only at symbols (the caller zero-fills it). State is in the JAX
// reference's layout: window (C, W) complex64, four (C,) float32 leaves
// and three (C,) complex64 leaves.
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

// The symbol step (DQPSKGardnerSymbolEvaluator), with the channel's last
// raw points and symbol.
struct GardnerStep {
  const float* bank;
  Loop k;
  Bases bs;
  float2 pm, pc, ps;

  // 8-tap interpolation at a fractional offset into the window: the
  // integer part picks the base, the fraction the arm.
  __device__ __forceinline__ float2 point(const Ring& r, float offset,
                                          int lo, int hi) const {
    const float kf = floorf(offset);
    const float* taps = bank + arm(offset - kf) * kNTaps;
    int base = static_cast<int>(kf);
    base = base < 0 ? 0 : (base > r.w - 8 ? r.w - 8 : base);
    float wr[kNTaps], wi[kNTaps];
#pragma unroll
    for (int j = 0; j < kNTaps; ++j) {
      const float2 v = r.at(base + j);
      wr[j] = v.x;
      wi[j] = v.y;
    }
    const float2 s = make_float2(interp8(taps, wr), interp8(taps, wi));
    return base >= lo && base <= hi ? s : make_float2(0.0f, 0.0f);
  }

  __device__ __forceinline__ uint8_t operator()(const Ring& r, float sp1,
                                                float phase, Timing& tm) {
    // --- the two points, each decoded against its previous sample ---
    const float2 mid = point(r, clip(sp1, 0.0f, 1.0f), bs.mid_lo, bs.mid_hi);
    const float2 cur = point(r, tm.dsps * 0.5f, bs.cur_lo, bs.cur_hi);
    const float2 ms = diff_norm(mid, pm);
    const float2 cs = diff_norm(cur, pc);

    // --- Gardner TED (DQPSKGardnerSymbolEvaluator.setSymbols) ---
    const float d_re = ps.x - cs.x, d_im = ps.y - cs.y;
    float terr = fma_f64(d_re, ms.x, d_im * ms.y);
    if (isnan(terr)) terr = 0.0f;
    terr = clip(terr, -0.3f, 0.3f);

    const Decision d = decide(cs.x, cs.y);
    update(terr, d.err, sp1, phase, k, tm);
    pm = mid;
    pc = cur;
    ps = cs;
    return d.byte;
  }
};

// G lanes a channel, K mixes a lane per pass (with_lanes: G * K covers a
// run, e.g. 8 or 9 samples at P25 Phase 2's 8.33 samples a symbol, 5 or 6
// at 5.21), the W-sample window in a ring of ring_size(W, G * K) samples.
template <int G, int K>
__global__ void __launch_bounds__(kBlock)
gardner_kernel(const float2* __restrict__ x, int T, int C, int W, int size,
               const float* __restrict__ bank_g, State in, StateOut st,
               uint8_t* __restrict__ out, Loop k, Bases bs) {
  constexpr int kGroups = kBlock / G;
  __shared__ float bank[(kNSteps + 1) * kNTaps];
  extern __shared__ float rings[];
  load_bank(bank, bank_g);
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int c = blockIdx.x * kGroups + group;
  if (c >= C) return;
  const unsigned gmask = group_mask<G>();

  Ring ring = load_ring<G>(rings, size, group,
                           in.win + static_cast<size_t>(c) * W, W, lane,
                           gmask);
  Timing tm{in.sp[c], in.dsps[c], in.ph[c], in.fr[c]};
  GardnerStep step{bank, k, bs, in.pm[c], in.pc[c], in.ps[c]};
  symbol_loop<G, K>(x + static_cast<size_t>(c) * T, T, ring, lane, gmask, tm,
                    step, out + c, C);

  store_ring<G>(ring, st.win + static_cast<size_t>(c) * W, lane);
  if (lane == 0) {
    st.sp[c] = tm.sp;
    st.dsps[c] = tm.dsps;
    st.ph[c] = tm.ph;
    st.fr[c] = tm.fr;
    st.pm[c] = step.pm;
    st.pc[c] = step.pc;
    st.ps[c] = step.ps;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a window length outside
// [kMinWindow, kMaxWindow] (11 for LSM at 25 kHz, 16 for P25 Phase 2 at
// 50 kHz, 20 for LSM at 48 or 50 kHz).
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
  return with_lanes(W, [&](auto lanes) {
    using L = decltype(lanes);
    constexpr int kGroups = kBlock / L::G;
    const int size = ring_size(W, L::G * L::K);
    gardner_kernel<L::G, L::K>
        <<<(C + kGroups - 1) / kGroups, kBlock, ring_bytes(kGroups, size),
           s>>>(xp, T, C, W, size, bp, in, st, op, k, bs);
  });
}
