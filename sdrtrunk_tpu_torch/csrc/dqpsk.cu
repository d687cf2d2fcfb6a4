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
template <int W>
struct DqpskStep {
  const float* bank;
  Loop k;
  float2 pp, pc;

  __device__ __forceinline__ uint8_t operator()(const Ring<W>& r, float sp1,
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

// G lanes a channel, K mixes a lane per pass: G * K covers a run (5 or 6
// samples at 5.21 samples a symbol; 8 or 9 at 8.33, P25 Phase 2's
// decision-directed timing at 50 kHz, W = 16).
template <int W, int G, int K>
__global__ void __launch_bounds__(kBlock)
dqpsk_kernel(const float2* __restrict__ x, int T, int C,
             const float* __restrict__ bank_g, State in, StateOut st,
             uint8_t* __restrict__ out, Loop k) {
  constexpr int kGroups = kBlock / G;
  __shared__ float bank[(kNSteps + 1) * kNTaps];
  __shared__ float ring_re[kGroups][kRing + 1], ring_im[kGroups][kRing + 1];
  load_bank(bank, bank_g);
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int c = blockIdx.x * kGroups + group;
  if (c >= C) return;
  const unsigned gmask = group_mask<G>();

  Ring<W> ring = load_ring<W, G>(ring_re[group], ring_im[group],
                                 in.win + static_cast<size_t>(c) * W, lane,
                                 gmask);
  Timing tm{in.sp[c], in.dsps[c], in.ph[c], in.fr[c]};
  DqpskStep<W> step{bank, k, in.pp[c], in.pc[c]};
  symbol_loop<W, G, K>(x + static_cast<size_t>(c) * T, T, ring, lane, gmask,
                       tm, step, out + c, C);

  store_ring<W, G>(ring, st.win + static_cast<size_t>(c) * W, lane);
  if (lane == 0) {
    st.sp[c] = tm.sp;
    st.dsps[c] = tm.dsps;
    st.ph[c] = tm.ph;
    st.fr[c] = tm.fr;
    st.pp[c] = step.pp;
    st.pc[c] = step.pc;
  }
}

template <int W, int G, int K>
void launch(const float2* x, int T, int C, const float* bank, State in,
            StateOut st, uint8_t* out, Loop k, cudaStream_t stream) {
  constexpr int kGroups = kBlock / G;
  const int grid = (C + kGroups - 1) / kGroups;
  dqpsk_kernel<W, G, K><<<grid, kBlock, 0, stream>>>(x, T, C, bank, in, st,
                                                     out, k);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a window length without an
// instantiation (W = floor(2 * samples/symbol); 10 at 25 kHz / 4800 Bd, 16
// at 50 kHz / 6000 Bd). W = 16 takes G = 16 lanes a channel, as gardner.cu's
// W = 16 does: G = 8 is also exact (a pass that ends before the symbol is
// carried on by the next), but then every 9-sample run would take two
// passes.
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
    case 8: launch<8, 8, 1>(xp, T, C, bp, in, st, op, k, s); break;
    case 9: launch<9, 8, 1>(xp, T, C, bp, in, st, op, k, s); break;
    case 10: launch<10, 8, 1>(xp, T, C, bp, in, st, op, k, s); break;
    case 11: launch<11, 8, 1>(xp, T, C, bp, in, st, op, k, s); break;
    case 12: launch<12, 8, 1>(xp, T, C, bp, in, st, op, k, s); break;
    case 16: launch<16, 16, 1>(xp, T, C, bp, in, st, op, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
