// Decision-directed DQPSK symbol recovery for Hopper (sm_90a).
//
// Replaces sdrtrunk_tpu/dsp/pallas_psk.py::_dqpsk_kernel (the Pallas TPU
// kernel behind DQPSKDemodulator.batched). Its plain PyTorch version is
// sdrtrunk_tpu_torch/dsp/psk.py::DQPSKDemodulator.scan_packed; the two
// use the same operations in the same order (psk_common.cuh), so on the
// card they agree bit for bit.
//
// Per sample: PLL mix into the delay line; then, where a symbol is due, an
// 8-tap interpolation at mu, the differential decode of it and of the
// preceding sample, the quadrant decision, and the timing and PLL updates.
//
// What bounds it: each channel's serial chain, not bytes (1023 x 10240
// samples move 94 MB, 28 us at 3.35 TB/s). Per symbol the chain is the
// run's mixes (float64 cos/sin) and the symbol step. The design is
// gardner.cu's (psk_common.cuh's symbol_loop): the symbol path once per
// symbol, a run's mixes spread over G lanes, G x 1023 threads over the
// card's SMs, the delay line a ring in shared memory, each channel reading
// its own row of the (C, T) stream a pass ahead. The 129x8 interpolator
// bank sits in shared memory (lanes read different arms, so __constant__
// would serialize).
//
// Layout: x is (C, T) complex64; out is (T, C) uint8 `dibit | valid << 2`,
// written only at symbols (the caller zero-fills it). State is in the JAX
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

// The symbol step (DQPSKDecisionDirectedSymbolEvaluator), with the
// channel's last preceding and current points.
struct DqpskStep {
  const float* bank;
  Loop k;
  float2 pp, pc;

  __device__ __forceinline__ uint8_t operator()(const Ring& r, float sp1,
                                                float phase, Timing& tm) {
    // --- interpolate at mu: arm by index, 8 taps left to right ---
    const float* taps = bank + arm(clip(sp1, 0.0f, 1.0f)) * kNTaps;
    float wr[kNTaps], wi[kNTaps];
#pragma unroll
    for (int j = 0; j < kNTaps; ++j) {
      const float2 v = r.at(j);
      wr[j] = v.x;
      wi[j] = v.y;
    }
    const float2 cur = make_float2(interp8(taps, wr), interp8(taps, wi));
    const float2 prec = make_float2(wr[kCenter], wi[kCenter]);

    // --- differential decode + normalize, quadrant decision ---
    const float pqn = diff_norm(prec, pp).y;
    const float2 cn = diff_norm(cur, pc);
    const Decision d = decide(cn.x, cn.y);
    const float polarity =
        (d.i_pos ? (pqn > cn.y) : (pqn < cn.y)) ? 1.0f : -1.0f;
    update(d.err * polarity, d.err, sp1, phase, k, tm);
    pp = prec;
    pc = cur;
    return d.byte;
  }
};

// G lanes a channel, K mixes a lane per pass (with_lanes: G * K covers a
// run, e.g. 5 or 6 samples at 5.21 samples a symbol, 8 or 9 at 8.33), the
// W-sample window in a ring of ring_size(W, G * K) samples.
template <int G, int K>
__global__ void __launch_bounds__(kBlock)
dqpsk_kernel(const float2* __restrict__ x, int T, int C, int W, int size,
             const float* __restrict__ bank_g, State in, StateOut st,
             uint8_t* __restrict__ out, Loop k) {
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
  DqpskStep step{bank, k, in.pp[c], in.pc[c]};
  symbol_loop<G, K>(x + static_cast<size_t>(c) * T, T, ring, lane, gmask, tm,
                    step, out + c, C);

  store_ring<G>(ring, st.win + static_cast<size_t>(c) * W, lane);
  if (lane == 0) {
    st.sp[c] = tm.sp;
    st.dsps[c] = tm.dsps;
    st.ph[c] = tm.ph;
    st.fr[c] = tm.fr;
    st.pp[c] = step.pp;
    st.pc[c] = step.pc;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a window length outside
// [kMinWindow, kMaxWindow] (W = floor(2 * samples/symbol); 10 at 25 kHz /
// 4800 Bd, 16 at 50 kHz / 6000 Bd, 20 at 48 or 50 kHz / 4800 Bd).
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
  return with_lanes(W, [&](auto lanes) {
    using L = decltype(lanes);
    constexpr int kGroups = kBlock / L::G;
    const int size = ring_size(W, L::G * L::K);
    dqpsk_kernel<L::G, L::K>
        <<<(C + kGroups - 1) / kGroups, kBlock, ring_bytes(kGroups, size),
           s>>>(xp, T, C, W, size, bp, in, st, op, k);
  });
}
