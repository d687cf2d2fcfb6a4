// Streaming biquad (transposed direct form II) for Hopper (sm_90a), over the
// rows of a (R, N) float32 or complex64 block, each row with its own state.
//
// Replaces the lax.scan of biquad_apply (sdrtrunk_tpu/dsp/misc.py:91, scan
// :109), vmapped over the leading axes; not a Pallas kernel. Its plain
// PyTorch version is sdrtrunk_tpu_torch/dsp/misc.py::biquad_apply_plain. The
// step is the plain loop's, in its order of operations:
//
//   y = b0 * x + z1;  z1 = b1 * x - a1 * y + z2;  z2 = b2 * x - a2 * y
//
// and the library is built with --fmad=false, so no product and sum are
// contracted into one rounding: on the card the two agree bit for bit. The
// coefficients are real (the RBJ designs), so a complex row is two
// independent real recurrences, one on the real parts and one on the
// imaginary parts, which are what the plain loop's complex operations
// compute with a zero imaginary coefficient.
//
// What bounds it: each row's serial chain, not bytes. A sample's y depends
// on z1, which depends on the last sample's y through a product, a
// difference and a sum: four dependent float32 operations a sample (about
// 16 cycles), against 8 bytes a float moved. At the bank's 1023 rows of
// 10240 floats that is 84 MB, 25 us at 3.35 TB/s, and about 83 us of
// chain. A time-parallel scan would reach the bytes but round each
// segment's carried state otherwise; the rows keep their serial order, so
// the design spreads the rows over the card and keeps every chain fed:
//
// * one warp a block serves kRows rows, one lane a row (1023 rows: 128
//   warps, one on each of 128 SMs);
// * each row streams through a ring of kStages stages of kTile floats in
//   shared memory, filled kStages - 1 tiles ahead. Where a row starts on 16
//   bytes (N floats a multiple of 4, x and y aligned), a row's tile is one
//   cp.async.bulk started by its lane, completing on the stage's mbarrier,
//   and y is written over x in place and stored by one cp.async.bulk while
//   the lane walks the next stage; otherwise the warp copies the tiles with
//   4-byte cp.async and stores y with plain coalesced stores;
// * a lane walks its row a float4 at a time, the next float4 read ahead of
//   the chain; a complex row's two real chains are walked by two lanes side
//   by side, each its own part of the interleaved floats (16 lanes for 8
//   rows).
//
// Layout: x and y are (R, NF) float32, NF = N floats a row (2 N for a
// complex row: re, im interleaved); the state is (R, 2) float32 (z1, z2) or
// (R, 2, 2) for complex rows ((z1.re, z1.im), (z2.re, z2.im)), as the
// reference's (..., 2) state of the row's dtype. R and N are C ints (the
// wrapper refuses more); within a row the kernel indexes in 64 bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 8;                  // rows a warp (= block)
constexpr int kTile = 512;                // floats of a row a stage
constexpr int kStride = kTile + 4;        // a stage's row in shared memory:
                                          // 16-byte aligned, and the lanes'
                                          // float4 reads in distinct banks
constexpr int kStages = 4;
constexpr size_t kSmem = sizeof(float) * kStages * kRows * kStride;

struct Coeffs {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ float step(const Coeffs& k, float x, float& z1,
                                      float& z2) {
  const float y = k.b0 * x + z1;
  z1 = k.b1 * x - k.a1 * y + z2;
  z2 = k.b2 * x - k.a2 * y;
  return y;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- the asynchronous copies (PTX) ---

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  }
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

// shared -> global in this thread's bulk group, committed
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk stores but the newest `kPending` have read shared memory
template <int kPending>
__device__ __forceinline__ void bulk_read_done() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kPending)
               : "memory");
}

__device__ __forceinline__ void bulk_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's writes to shared memory, seen by the bulk copies after it
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's 4-byte copies but the newest kPending groups have landed
template <int kPending>
__device__ __forceinline__ void copy4_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// --- the kernel ---

// Tile `t` (n floats from t0) of the block's rows into stage `buf`: one
// bulk copy a row by its lane (kBulk), or 4-byte copies by the whole warp.
template <bool kBulk>
__device__ __forceinline__ void fill(float* buf, uint64_t* bar,
                                     const float* xb, long long NF,
                                     long long t0, int n, int rows,
                                     int lane) {
  if constexpr (kBulk) {
    if (lane < rows) {
      bar_expect(bar, 4u * n);
      bulk_load(buf + lane * kStride, xb + lane * NF + t0, 4u * n, bar);
    }
  } else {
    for (int r = 0; r < rows; ++r)
      for (int f = lane; f < n; f += 32)
        copy4(buf + r * kStride + f, xb + r * NF + t0 + f);
  }
}

// A lane's walk over n floats of its row in shared memory, y over x: a
// float32 row's every float, or one part (v: 0 real, 1 imaginary) of a
// complex row's interleaved floats, the other lane of the row walking the
// other part beside it.
template <int kV>
__device__ __forceinline__ void walk(float* row, int n, int v,
                                     const Coeffs& k, float& z1, float& z2) {
  const int n4 = n & ~3;
  if (n4 > 0) {
    float4 cur = *reinterpret_cast<const float4*>(row);
    for (int f = 0; f < n4; f += 4) {
      // read ahead (past the tile: the row's padding, unused)
      const float4 nxt = *reinterpret_cast<const float4*>(row + f + 4);
      if constexpr (kV == 1) {
        float4 out;
        out.x = step(k, cur.x, z1, z2);
        out.y = step(k, cur.y, z1, z2);
        out.z = step(k, cur.z, z1, z2);
        out.w = step(k, cur.w, z1, z2);
        *reinterpret_cast<float4*>(row + f) = out;
      } else {
        row[f + v] = step(k, v ? cur.y : cur.x, z1, z2);
        row[f + 2 + v] = step(k, v ? cur.w : cur.z, z1, z2);
      }
      cur = nxt;
    }
  }
  for (int f = n4 + v; f < n; f += kV)      // an unaligned row's tail
    row[f] = step(k, row[f], z1, z2);
}

// kV floats a sample: 1 for float32 rows, 2 (re, im) for complex64 rows,
// and kV lanes a row: lane l walks part l % kV of row l / kV; lane r starts
// row r's bulk copies.
template <int kV, bool kBulk>
__global__ void __launch_bounds__(32)
biquad_kernel(const float* __restrict__ x, float* __restrict__ y, int R,
              long long NF, Coeffs k, const float* __restrict__ st_in,
              float* __restrict__ st_out) {
  extern __shared__ __align__(16) float stages[];  // [kStages][kRows][kStride]
  __shared__ uint64_t full[kStages];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - r0);
  const bool owner = lane < rows;           // row `lane`'s bulk copies
  const bool walker = lane < kV * rows;     // part v of row wr
  const int wr = lane / kV, v = lane % kV;
  const size_t srow = (static_cast<size_t>(r0) + wr) * 2 * kV + v;
  float z1 = walker ? st_in[srow] : 0.f;
  float z2 = walker ? st_in[srow + kV] : 0.f;
  const float* xb = x + static_cast<size_t>(r0) * NF;
  float* yb = y + static_cast<size_t>(r0) * NF;
  const long long tiles = (NF + kTile - 1) / kTile;
  if (kBulk && lane == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s], rows);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  // the prologue: tiles 0 .. kStages - 2 in flight (a commit group each)
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < tiles) {
      const long long t0 = static_cast<long long>(i) * kTile;
      fill<kBulk>(stages + i * kRows * kStride, &full[i], xb, NF, t0,
                  static_cast<int>(min(static_cast<long long>(kTile),
                                       NF - t0)),
                  rows, lane);
    }
    if (!kBulk) copy4_commit();
  }
  // --- start
  for (long long i = 0; i < tiles; ++i) {
    const int s = static_cast<int>(i % kStages);
    const long long t0 = i * kTile;
    const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                       NF - t0));
    float* buf = stages + s * kRows * kStride;
    // --- stage
    if constexpr (kBulk) {
      if (walker)
        bar_wait(&full[s], static_cast<uint32_t>((i / kStages) & 1));
    } else {
      copy4_wait<kStages - 2>();
      __syncwarp();
    }
    // --- walk
    if (walker) walk<kV>(buf + wr * kStride, n, v, k, z1, z2);
    // --- store
    if constexpr (kBulk) {
      if (walker) fence_async();
      if (kV > 1) __syncwarp();             // both parts of a row written
      if (owner)
        bulk_store(yb + lane * NF + t0, buf + lane * kStride, 4u * n);
    } else {
      __syncwarp();
      for (int r = 0; r < rows; ++r)
        for (int f = lane; f < n; f += 32)
          yb[r * NF + t0 + f] = buf[r * kStride + f];
      __syncwarp();
    }
    // the stage of tile i - 1 takes tile i + kStages - 1, once tile i - 1's
    // stores have read it
    const long long nt = i + kStages - 1;
    if (nt < tiles) {
      const int ns = static_cast<int>(nt % kStages);
      if (kBulk && owner) bulk_read_done<1>();
      fill<kBulk>(stages + ns * kRows * kStride, &full[ns], xb, NF,
                  nt * kTile,
                  static_cast<int>(min(static_cast<long long>(kTile),
                                       NF - nt * kTile)),
                  rows, lane);
    }
    if (!kBulk) copy4_commit();
    // --- next
  }
  // --- end
  if (kBulk && owner) bulk_done();
  if (walker) {
    st_out[srow] = z1;
    st_out[srow + kV] = z2;
  }
}

template <int kV, bool kBulk>
int launch(const float* x, float* y, int R, long long NF, const Coeffs& k,
           const float* si, float* so, cudaStream_t st) {
  auto* fn = biquad_kernel<kV, kBulk>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fn<<<(R - 1) / kRows + 1, 32, kSmem, st>>>(x, y, R, NF, k, si, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a negative count.
extern "C" int biquad_launch(const void* x, void* y, int R, int N,
                             int is_complex, float b0, float b1, float b2,
                             float a1, float a2, const void* st_in,
                             void* st_out, void* stream) {
  if (R < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const Coeffs k{b0, b1, b2, a1, a2};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  auto* ys = static_cast<float*>(y);
  const auto* si = static_cast<const float*>(st_in);
  auto* so = static_cast<float*>(st_out);
  const long long NF = is_complex ? 2LL * N : N;
  const bool bulk = NF % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (is_complex)
    return bulk ? launch<2, true>(xs, ys, R, NF, k, si, so, st)
                : launch<2, false>(xs, ys, R, NF, k, si, so, st);
  return bulk ? launch<1, true>(xs, ys, R, NF, k, si, so, st)
              : launch<1, false>(xs, ys, R, NF, k, si, so, st);
}
