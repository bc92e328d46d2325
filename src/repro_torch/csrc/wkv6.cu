// RWKV-6 WKV recurrence for Hopper (sm_90a).  Per (batch b, head h), with
// an hd x hd fp32 state S:
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T,          S_{-1} = s0,
// and the final state written to s_last.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py
// `wkv6_padded` / `_wkv_kernel` (K10).  The TPU kernel keeps the [hd, hd]
// state as one VMEM tile and runs each step as rank-1 VPU outer products
// over a sequential time-block grid dimension, with S padded to a block
// multiple (padded steps w = 1, k = 0 leave the state unchanged).
//
// What bounds it on an H100: bytes, narrowly, and in practice the serial
// step chain.  Each step does 4 hd^2 fp32 operations per (b, h) against
// 5 hd fp32 values moved: at rwkv6-1.6b's width (H = 32, hd = 64)
// 4 * 32 * 4096 = 0.52 MFLOP a token, 7.8 us a thousand tokens at the
// 67 TFLOP/s fp32 (non-tensor) peak, while its bytes (r, k, v, w in, out
// out: 20 * 2048 = 41 KB a token) take 12 us at 3.35 TB/s.  The first port
// ran one block of hd threads a (b, h) (32 blocks at batch 1, a quarter of
// the SMs), loaded each step's rows from device memory at the top of the
// step (a load latency before every step's barrier) and ran a chain of hd
// dependent FMAs a step: 0.075 ms at S = 46, 85x its bound.
//
// The design (wkv6_kernel):
//  * More SMs.  Column j of the state needs only v_j and the shared r, k,
//    w, u, so the hd columns of a (b, h) split over hd / 16 blocks of 16
//    columns: B H hd / 16 blocks, 128 at batch 1 and rwkv6's width.
//  * A shorter chain.  Each column's hd rows split over hd / 8 threads,
//    8 rows a thread held in registers (two 16-byte groups, interleaved
//    over the column's threads so their shared-memory reads hit distinct
//    banks): a step is 8 rows' terms in two accumulators, 4 dependent
//    FMAs, not hd FMAs and a barrier.  The threads' partial sums of out_j
//    go to shared memory and are summed once a chunk, so nothing in a
//    step waits on another thread; each step's operands are loaded into
//    registers one step ahead.
//  * Staging.  The rows r_t, k_t, w_t and the block's 16 columns of v_t
//    of WKV_STEPS = 32 steps at a time go to shared memory by cp.async,
//    double-buffered: the next chunk is in flight while the current one
//    is consumed, so no step waits on device memory, and a chunk costs
//    two barriers, not a step.
// Per term the arithmetic is the reference's (kv = k_i v_j; r_i (S_ij +
// u_i kv); S_ij = w_i S_ij + kv), rounded as the plain PyTorch version
// rounds it — each product and sum on its own, no FMA contraction — so
// the state the recurrence carries, and s_last, equal the plain
// version's on the same inputs, and the two paths differ only in out_j,
// which sums its hd terms in another order (two accumulators a thread,
// then the column's threads in order) and feeds nothing back.  (With
// contracted FMAs the state drifts from the plain version's by an ulp a
// step, and rwkv6's layers amplify that drift; PERF.md.)
// Exact S: there are no padded steps to leak into s_last.  Tensors stay in
// the model layout ([B, S, H, hd]; u [H, hd]; s0 / s_last [B, H, hd, hd]),
// so no transposed copies are made around the call.
#include "attn_tiles.cuh"

namespace repro_torch {

constexpr int WKV_COLS = 16;        // state columns a block
constexpr int WKV_ROWS = 8;         // state rows a thread
constexpr int WKV_STEPS = 32;       // steps a staged chunk

template <int HD>
struct WkvGeom {
  static constexpr int GROUPS = HD / WKV_COLS;        // blocks a (b, h)
  static constexpr int SPLIT = HD / WKV_ROWS;         // threads a column
  static constexpr int THREADS = WKV_COLS * SPLIT;
  static constexpr int ROW_F = 3 * HD + WKV_COLS;     // floats a step
  static constexpr int PIECES = ROW_F / 4;            // 16-byte pieces a step
  static constexpr int CHUNK_F = WKV_STEPS * ROW_F;
  static constexpr int PART_F = WKV_STEPS * THREADS;  // partial sums
  static constexpr size_t SMEM = (2 * CHUNK_F + PART_F) * sizeof(float);
  static_assert(HD % WKV_COLS == 0 && HD % WKV_ROWS == 0, "whole groups");
};

// a step's operands of one thread: its two 16-byte groups of r, k, w rows
// and v_j
struct WkvStep {
  float4 r[2], k[2], w[2];
  float v;
};

template <int HD>
__device__ __forceinline__ void wkv_load(WkvStep& o, const float* x, int g,
                                         int c) {
  constexpr int SPLIT = WkvGeom<HD>::SPLIT;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = 4 * (g + SPLIT * s);
    o.r[s] = *reinterpret_cast<const float4*>(x + q);
    o.k[s] = *reinterpret_cast<const float4*>(x + HD + q);
    o.w[s] = *reinterpret_cast<const float4*>(x + 2 * HD + q);
  }
  o.v = x[3 * HD + c];
}

template <int HD>
__global__ void __launch_bounds__(WkvGeom<HD>::THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ s_last, int S,
            int H) {
  using Gm = WkvGeom<HD>;
  constexpr int SPLIT = Gm::SPLIT;
  // [2][32 steps][ROW_F] staged rows, then [32 steps][THREADS] partials
  extern __shared__ __align__(16) float wkv_smem[];
  float* part = wkv_smem + 2 * Gm::CHUNK_F;
  const int bh = blockIdx.x / Gm::GROUPS;
  const int b = bh / H, h = bh % H;
  const int c0 = (blockIdx.x % Gm::GROUPS) * WKV_COLS;
  const int c = threadIdx.x / SPLIT, g = threadIdx.x % SPLIT;
  const int j = c0 + c;                               // the state column
  const int64_t state0 = static_cast<int64_t>(bh) * HD * HD;

  // row (b, t, h) of a [B, S, H, HD] tensor
  auto row = [&](int t) {
    return ((static_cast<int64_t>(b) * S + t) * H + h) * HD;
  };
  // chunk n's steps into buffer n % 2: per step [r | k | w | v columns]
  const int chunks = (S + WKV_STEPS - 1) / WKV_STEPS;
  auto issue = [&](int n) {
    float* dst = wkv_smem + (n & 1) * Gm::CHUNK_F;
    const int t0 = n * WKV_STEPS;
    const int pieces = min(WKV_STEPS, S - t0) * Gm::PIECES;
    for (int i = threadIdx.x; i < pieces; i += Gm::THREADS) {
      const int tt = i / Gm::PIECES, p = i % Gm::PIECES;
      const int64_t o = row(t0 + tt);
      const float* src;
      if (p < HD / 4)
        src = r + o + 4 * p;
      else if (p < HD / 2)
        src = k + o + 4 * (p - HD / 4);
      else if (p < 3 * HD / 4)
        src = w + o + 4 * (p - HD / 2);
      else
        src = v + o + c0 + 4 * (p - 3 * HD / 4);
      cp_async16(dst + tt * Gm::ROW_F + 4 * p, src, true);
    }
    cp_async_commit();
  };
  issue(0);

  // this thread's rows: groups g + SPLIT s, rows 4 (g + SPLIT s) + e, held
  // as st[4 s + e]
  float st[WKV_ROWS], us[WKV_ROWS];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (g + SPLIT * s) + e;
      st[4 * s + e] = s0[state0 + static_cast<int64_t>(i) * HD + j];
      us[4 * s + e] = u[h * HD + i];
    }

  for (int n = 0; n < chunks; ++n) {
    if (n + 1 < chunks) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // chunk n landed for everyone
    const float* buf = wkv_smem + (n & 1) * Gm::CHUNK_F;
    const int t0 = n * WKV_STEPS, steps = min(WKV_STEPS, S - t0);
    WkvStep nx;
    wkv_load<HD>(nx, buf, g, c);
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      const WkvStep x = nx;
      if (tt + 1 < steps) wkv_load<HD>(nx, buf + (tt + 1) * Gm::ROW_F, g, c);
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float rr[4] = {x.r[s].x, x.r[s].y, x.r[s].z, x.r[s].w};
        const float kk[4] = {x.k[s].x, x.k[s].y, x.k[s].z, x.k[s].w};
        const float ww[4] = {x.w[s].x, x.w[s].y, x.w[s].z, x.w[s].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& si = st[4 * s + e];
          // the plain version's roundings: separate products and sums
          // (no FMA contraction), so the state stays its bit for bit
          const float kv = __fmul_rn(kk[e], x.v);
          acc[e & 1] = fmaf(
              rr[e], __fadd_rn(si, __fmul_rn(us[4 * s + e], kv)), acc[e & 1]);
          si = __fadd_rn(__fmul_rn(ww[e], si), kv);
        }
      }
      part[tt * Gm::THREADS + threadIdx.x] = acc[0] + acc[1];
    }
    __syncthreads();                        // buffer n % 2 consumed
    // out_j of the chunk's steps: the column's SPLIT partials in order
    for (int i = threadIdx.x; i < steps * WKV_COLS; i += Gm::THREADS) {
      const int tt = i / WKV_COLS, cc = i % WKV_COLS;
      const float* pp = part + tt * Gm::THREADS + cc * SPLIT;
      float o = pp[0];
#pragma unroll
      for (int q = 1; q < SPLIT; ++q) o += pp[q];
      out[row(t0 + tt) + c0 + cc] = o;
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (g + SPLIT * s) + e;
      s_last[state0 + static_cast<int64_t>(i) * HD + j] = st[4 * s + e];
    }
}

template <int HD>
int wkv6_launch_hd(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* out,
                   void* s_last, int B, int S, int H, cudaStream_t stream) {
  using Gm = WkvGeom<HD>;
  auto kernel = wkv6_kernel<HD>;
  if (Gm::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Gm::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B * H * Gm::GROUPS, Gm::THREADS, Gm::SMEM, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_last), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// r, k, v, w, out: [B, S, H, hd] fp32; u: [H, hd]; s0, s_last:
// [B, H, hd, hd]; all contiguous and 16-byte aligned.  hd in {16, 32, 64}.
// Returns the cudaError_t of the launch (0 = queued).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* out, void* s_last, int B, int S, int H,
                           int hd, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || H < 1 ||
      static_cast<int64_t>(B) * H * (hd / WKV_COLS) > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return wkv6_launch_hd<16>(r, k, v, w, u, s0, out, s_last, B, S, H, s);
    case 32:
      return wkv6_launch_hd<32>(r, k, v, w, u, s0, out, s_last, B, S, H, s);
    case 64:
      return wkv6_launch_hd<64>(r, k, v, w, u, s0, out, s_last, B, S, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
