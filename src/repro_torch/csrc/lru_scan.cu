// RG-LRU linear recurrence for Hopper (sm_90a):
//   h_t = exp(log_a_t) * h_{t-1} + x_t,   h_{-1} = 0,
// elementwise over [B, S, W] in fp32.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py
// `lru_scan_padded` / `_lru_kernel` (K9).  The TPU kernel tiles (batch,
// width) over the grid's parallel dimensions and carries the state in VMEM
// across a sequential time-block dimension; it needs S and W padded to
// block multiples.  Here the recurrence is serial in t and independent in
// (b, w), so one thread owns one channel (b, w) for the whole sequence with
// its state in a register; exact S and W, no padding.  Neighbouring threads
// take neighbouring w, so every load and store of a time step is one
// coalesced 128-byte row segment per warp.
//
// What bounds it on an H100: bytes.  It reads log_a and x and writes h once,
// 12 bytes per element: at recurrentgemma-2b's prefill shape (B = 1,
// W = 2560, S = 2049) 63 MB, 0.019 ms at 3.35 TB/s; the operations (exp,
// mul, add per element) are far below the fp32 peak.  This first kernel is
// latency-bound instead: with B = 1 only W / 64 = 40 blocks are in flight
// on 132 SMs, and each thread walks S steps in order.  To keep the memory
// system busy, a thread loads CHUNK steps of (log_a, x) into registers
// before it runs their recurrence, so CHUNK independent loads are in flight
// per thread instead of one.  A chunked two-pass scan (per-chunk
// (prod a, local h) then a carry pass over chunks) that fills the card is
// later work (ROADMAP queue 2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int LRU_THREADS = 64;     // channels per block
constexpr int LRU_CHUNK = 8;        // time steps loaded ahead per thread

__global__ void __launch_bounds__(LRU_THREADS)
lru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
                float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * LRU_THREADS + threadIdx.x;
  if (w >= W) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * W + w;
  float state = 0.f;
  for (int t0 = 0; t0 < S; t0 += LRU_CHUNK) {
    float la[LRU_CHUNK], xv[LRU_CHUNK];
#pragma unroll
    for (int c = 0; c < LRU_CHUNK; ++c) {
      const int t = t0 + c;
      const int64_t i = base + static_cast<int64_t>(t) * W;
      la[c] = t < S ? log_a[i] : 0.f;
      xv[c] = t < S ? x[i] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < LRU_CHUNK; ++c) {
      const int t = t0 + c;
      if (t < S) {
        state = expf(la[c]) * state + xv[c];
        h[base + static_cast<int64_t>(t) * W] = state;
      }
    }
  }
}

}  // namespace repro_torch

// log_a, x, h: [B, S, W] fp32, contiguous.  Returns the cudaError_t of the
// launch (0 = queued).
extern "C" int lru_scan_launch(const void* log_a, const void* x, void* h,
                               int B, int S, int W, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + LRU_THREADS - 1) / LRU_THREADS, B);
  lru_scan_kernel<<<grid, LRU_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(x),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}
