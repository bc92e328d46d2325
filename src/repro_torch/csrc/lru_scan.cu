// RG-LRU linear recurrence for Hopper (sm_90a):
//   h_t = exp(log_a_t) * h_{t-1} + x_t,   h_{-1} = 0,
// elementwise over [B, S, W] in fp32, at exact S and W (no padding).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py
// `lru_scan_padded` / `_lru_kernel` (K9).  The TPU kernel tiles (batch,
// width) over the grid's parallel dimensions and carries the state in VMEM
// across a sequential time-block dimension, with S and W padded to block
// multiples.  Here a block's warps split the time dimension instead, as a
// scan under the associative operator
//   (P1, h1) o (P2, h2) = (P1 P2, P2 h1 + h2)
// (a run of steps maps a state c to P c + h).
//
// What bounds it on an H100: bytes.  It reads log_a and x and writes h once,
// 12 bytes an element: at recurrentgemma-2b's prefill shape (B = 1, W =
// 2560, S = 2049) 63 MB, 0.019 ms at 3.35 TB/s; the operations (exp, mul,
// add) are far below the fp32 peak.  The first port gave one thread a
// channel for the whole sequence: 40 blocks of 64 channels on 132 SMs at
// batch 1, each thread walking S dependent rounds of loads, 13x its bound.
//
// The design (lru_scan_kernel), one launch, no workspace, no atomics:
//  * A block holds 32 consecutive channels (one 128-byte row a step) of one
//    batch row and walks the sequence in super-chunks of warps x steps
//    steps, each split over its warps in contiguous runs of `steps` steps.
//    Each warp stages its run's log_a and x rows into shared memory by
//    cp.async (16 bytes a copy where W allows, 4 otherwise: 4-byte copies
//    alone are 40% slower at S 2049, PERF.md), the next super-chunk's
//    (double-buffered) while it scans the current one, so all of a run's
//    loads are in flight before any arithmetic and reads overlap the scan
//    and the stores.
//  * Each lane (one channel) scans its run from zero: the local state h and
//    the product P of the run's a = expf(log_a), both kept in shared memory
//    in place of x and log_a.
//  * The warps' totals (P, h) go to shared memory; each warp folds those of
//    the warps before it into the state entering the super-chunk, and
//    every warp folds all of them into the state entering the next.
//  * Output: h_t = h_local_t + P_t carry, written as 128-byte rows.
// The split comes from lru_scan_splits (kernels/rglru_scan/kernel.py),
// tuned by the card's forced-split sweep (chip_smoke.py, PERF.md).
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, no
// contracted FMA), as the plain version's separate torch ops round them,
// so a run that holds the whole sequence gives the plain version's result
// bit for bit (its carry is the zero state: h_local + P 0 = h_local);
// elsewhere the carries regroup the same products.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tiles.cuh"

namespace repro_torch {

constexpr int LRU_CH = 32;          // channels a block (a warp's lanes)
constexpr int LRU_MAX_WARPS = 16;   // warps a block

// 4-byte asynchronous copy global -> shared; pred false zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// the state c carried through a run whose total is (P, h): P c + h,
// rounded as the plain version rounds a step
__device__ __forceinline__ float lru_fold(float c, float2 t) {
  return __fadd_rn(__fmul_rn(t.x, c), t.y);
}

// shared memory: [bufs][log_a | x][warps * steps][32] staged rows, then
// the warps' totals [2][warps][32] (float2 (P, h), double-buffered by
// super-chunk parity)
__host__ __device__ inline size_t lru_smem_bytes(int warps, int steps,
                                                 int bufs) {
  return (static_cast<size_t>(bufs) * 2 * warps * steps * LRU_CH +
          2 * warps * LRU_CH * 2) * sizeof(float);
}

template <bool VEC>
__global__ void __launch_bounds__(LRU_MAX_WARPS * 32)
lru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
                float* __restrict__ h, int S, int W, int steps) {
  extern __shared__ __align__(16) float lru_smem[];
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c0 = blockIdx.x * LRU_CH, c = c0 + lane;
  const int span = warps * steps;                 // a super-chunk's steps
  const int chunks = (S + span - 1) / span;
  const int bufs = min(chunks, 2);
  float2* tot =
      reinterpret_cast<float2*>(lru_smem + 2 * bufs * span * LRU_CH);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * W;

  // this warp's run of super-chunk k: steps [t0, t0 + n), staged at rows
  auto run_t0 = [&](int k) {
    return static_cast<int64_t>(k) * span + static_cast<int64_t>(w) * steps;
  };
  auto run_n = [&](int64_t t0) {
    const int64_t left = S - t0;
    return left <= 0 ? 0 : static_cast<int>(left < steps ? left : steps);
  };
  auto rows = [&](int k) {
    return lru_smem + (k & 1) * 2 * span * LRU_CH + w * steps * LRU_CH;
  };
  auto issue = [&](int k) {
    const int64_t t0 = run_t0(k);
    const int n = run_n(t0);
    float* la_s = rows(k);
    float* x_s = la_s + span * LRU_CH;
    if (VEC) {            // a row is 8 pieces of 16 bytes; a warp, 4 rows
      for (int i = lane; i < n * 8; i += 32) {
        const int tt = i / 8, q = 4 * (i % 8);
        const bool ok = c0 + q < W;
        const int64_t g = base + (t0 + tt) * W + c0 + q;
        cp_async16(la_s + tt * LRU_CH + q, ok ? log_a + g : log_a, ok);
        cp_async16(x_s + tt * LRU_CH + q, ok ? x + g : x, ok);
      }
    } else {              // a lane, its channel of every row
      const bool ok = c < W;
      for (int tt = 0; tt < n; ++tt) {
        const int64_t g = base + (t0 + tt) * W + c;
        cp_async4(la_s + tt * LRU_CH + lane, ok ? log_a + g : log_a, ok);
        cp_async4(x_s + tt * LRU_CH + lane, ok ? x + g : x, ok);
      }
    }
    cp_async_commit();
  };

  issue(0);
  float carry = 0.f;                        // the state entering chunk k
  for (int k = 0; k < chunks; ++k) {
    __syncwarp();                           // chunk k - 1's reads are done
    if (k + 1 < chunks) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();                           // the run's rows have landed
    const int64_t t0 = run_t0(k);
    const int n = run_n(t0);
    float* la_s = rows(k);
    float* x_s = la_s + span * LRU_CH;

    // the run from zero: h_local in place of x, P in place of log_a
    float P = 1.f, hl = 0.f;
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const int i = tt * LRU_CH + lane;
      const float a = expf(la_s[i]);
      hl = __fadd_rn(__fmul_rn(a, hl), x_s[i]);
      P = __fmul_rn(a, P);
      x_s[i] = hl;
      la_s[i] = P;
    }
    // the totals are double-buffered: a warp writes chunk k + 2's only
    // after chunk k + 1's barrier, which every warp passes after its reads
    float2* tk = tot + (k & 1) * warps * LRU_CH;
    tk[w * LRU_CH + lane] = make_float2(P, hl);
    __syncthreads();                        // every warp's total

    // this warp's carry-in, through the warps before it; the state after
    // the super-chunk, through all of them in the same order
    float cw = carry;
    for (int v = 0; v < w; ++v) cw = lru_fold(cw, tk[v * LRU_CH + lane]);
    float cnext = cw;
    for (int v = w; v < warps; ++v)
      cnext = lru_fold(cnext, tk[v * LRU_CH + lane]);
    if (c < W && n > 0) {
      float* out = h + base + t0 * W + c;
      for (int tt = 0; tt < n; ++tt) {
        const int i = tt * LRU_CH + lane;
        out[static_cast<int64_t>(tt) * W] =
            __fadd_rn(x_s[i], __fmul_rn(la_s[i], cw));
      }
    }
    carry = cnext;
  }
}

template <bool VEC>
int lru_launch(const float* log_a, const float* x, float* h, int B, int S,
               int W, int warps, int steps, cudaStream_t stream) {
  auto kernel = lru_scan_kernel<VEC>;
  const int64_t span = static_cast<int64_t>(warps) * steps;
  const int bufs = (S + span - 1) / span > 1 ? 2 : 1;
  const size_t smem = lru_smem_bytes(warps, steps, bufs);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // grid (channel tiles, B)
  kernel<<<dim3((W + LRU_CH - 1) / LRU_CH, B), 32 * warps, smem, stream>>>(
      log_a, x, h, S, W, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// log_a, x, h: [B, S, W] fp32, contiguous.  The split: `warps` warps a
// block of 32 channels, `steps` steps a warp's run of a super-chunk
// (lru_scan_splits in kernels/rglru_scan/kernel.py).  Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int lru_scan_launch(const void* log_a, const void* x, void* h,
                               int B, int S, int W, int warps, int steps,
                               void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || W < 1 || B > 65535 || warps < 1 ||
      warps > LRU_MAX_WARPS || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies where every row of 32 channels starts 16-byte aligned
  const bool vec = W % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(log_a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* xx = static_cast<const float*>(x);
  float* hh = static_cast<float*>(h);
  return vec ? lru_launch<true>(la, xx, hh, B, S, W, warps, steps, s)
             : lru_launch<false>(la, xx, hh, B, S, W, warps, steps, s);
}
