// Paged ring-window chunked-prefill attention for Hopper (sm_90a), fp or
// int8 snapshot pages (K5, and its K8 branch).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_ring_prefill_kernel` / `_paged_ring_prefill_kernel`: one
// request's bucketed chunk of S queries (query i at absolute position
// qpos = start + i) of a sliding-window family, with snapshot-before-write
// semantics.  The chunk's writes wrap onto ring cells its own early
// queries still need, so the kernel reads the ring as it was BEFORE the
// chunk's writes and takes the chunk's own keys / values as separate
// operands.  Two phases fold into one online softmax:
//   1. the ring snapshot: cells idx < min(start, window) of the request's
//      ring of n_table cells, each at position
//      kpos = cur - floormod(cur - idx, window) with cur = start - 1, kept
//      where kpos >= 0 (written) and kpos > qpos - window (in the window;
//      the snapshot precedes the chunk, so causality holds by itself);
//   2. the chunk's own keys chunk_k / chunk_v [S, KV, hd] (in q's dtype),
//      key j at kpos = start + j, kept where j < n_valid, kpos <= qpos and
//      kpos > qpos - window.
// Queries at or past n_valid write 0, and a block of padding queries
// touches no key.  int8 snapshot pages (K8) carry one bf16 scale per
// (page, offset, kv-head) row: raw scores times the key scale before the
// mask, probabilities times the value scale before the PV product, the
// denominator unscaled; the chunk operands are fp (scale 1).  Masked
// scores take the finite NEG_INF; the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  A 1024-query chunk that wraps
// mixtral's 4096-token ring (KV 8, G 6, hd 128) keeps ~25 M (query head,
// key) pairs, ~100 GFLOP: 0.10 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 16 MB of ring pages (5 us at 3.35 TB/s).  A verify row
// (S = 5) is the opposite: 30 query rows per kv-head against the whole
// ring, bound by the 16 MB of bytes, and only 8 (kv-head) units of work.
//
// The bf16 design is the tensor-core body shared with K2
// (paged_prefill_body.cuh, RING = true): rows r = i * G + g in 64-row
// tiles, one warpgroup each; keys walked by absolute position — a
// position below start is the ring row of cell p % window (kept if that
// cell is in the table), one at or past start is chunk row p - start —
// over exactly the keys some row keeps, masked only at the window edge,
// the causal diagonal and in a ring shorter than the window; wgmma for
// Q K^T and P V (P as hi + lo bf16); int8 snapshot rows widened exactly
// from a staging buffer; short chunks split their key tiles over
// blockIdx.z (`prefill_splits` in kernels/paged_attention/kernel.py) and a
// second kernel merges the fp32 partials.
//
// fp32 (paged_ring_prefill_kernel<float, ...>) keeps the scalar body of
// the first port — one block per (kv-head, 8 queries), one warp per query
// over page tiles in shared memory — chosen by dtype alone.  It is what the
// fp32 arms run, holding teacher-forced logits within 1e-3 of the plain
// path; TF32 tensor cores (10-bit mantissa) would spend that margin.
#include "paged_prefill_body.cuh"

#include <type_traits>

namespace repro_torch {

// ---------------------------------------------------------------------------
// fp32 scalar kernel (the first port's body, unchanged)
// ---------------------------------------------------------------------------

constexpr int QB = 8;          // queries per block = warps per block
constexpr int MAXG = 8;        // largest GQA group the kernel holds

template <typename T, typename PT, int HD>
__global__ void paged_ring_prefill_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const T* __restrict__ chunk_k, const T* __restrict__ chunk_v,
    const int* __restrict__ page_row, T* __restrict__ out, int S, int KV,
    int G, int ps, int n_table, int start, int n_valid, int window,
    float scale) {
  constexpr int E = HD / 32;
  constexpr bool QUANT = sizeof(PT) == 1;
  extern __shared__ float smem[];
  float* k_tile = smem;                     // [ps, HD]
  float* v_tile = k_tile + ps * HD;         // [ps, HD]
  float* scores = v_tile + ps * HD;         // [QB, MAXG, ps]
  float* ks = scores + QB * MAXG * ps;      // [ps] (int8 snapshot pages)
  float* vs = ks + ps;                      // [ps]

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = q0 + w;                     // this warp's query
  float* sc = scores + w * MAXG * ps;

  // out/q [S, KV, G, HD]
  auto row_off = [&](int g) {
    return ((static_cast<int64_t>(i) * KV + h) * G + g) * HD;
  };

  if (q0 >= n_valid) {                      // all-padding block: emit 0
    if (i < S)
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[row_off(g) + lane * E + e] = from_f32<T>(0.f);
    return;
  }

  const bool active = i < n_valid;          // n_valid <= S
  const int qpos = start + i;
  const int cur = start - 1;                // newest snapshot position

  float qv[MAXG][E], acc[MAXG][E], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = (active && g < G) ? to_f32(q[row_off(g) + lane * E + e])
                                   : 0.f;
    }
  }

  // phase 1: the pre-write ring snapshot — its live cells hold positions
  // [max(0, start - window), start), exactly min(start, window) of them,
  // from cell 0 up
  const int cells = min(start, window);
  const int n_ring = min(n_table, (cells + ps - 1) / ps);
  // phase 2: chunk keys up to the block's last valid query
  const int keys = min(n_valid, q0 + QB);
  const int n_chunk = (keys + ps - 1) / ps;
  for (int p = 0; p < n_ring + n_chunk; ++p) {
    const bool ring = p < n_ring;
    const int base = ring ? p * ps : (p - n_ring) * ps;
    __syncthreads();                        // previous tile fully consumed
    if (ring) {
      const int page = page_row[p];
      load_tile<PT, HD>(k_tile, k_pages, page, ps, KV, h);
      load_tile<PT, HD>(v_tile, v_pages, page, ps, KV, h);
      if (QUANT) {
        load_scales(ks, k_scale, page, ps, KV, h);
        load_scales(vs, v_scale, page, ps, KV, h);
      }
    } else {
      const int64_t off = (static_cast<int64_t>(base) * KV + h) * HD;
      const int64_t stride = static_cast<int64_t>(KV) * HD;
      load_rows<T, HD>(k_tile, chunk_k + off, stride, ps, S - base);
      load_rows<T, HD>(v_tile, chunk_v + off, stride, ps, S - base);
    }
    __syncthreads();
    if (!active) continue;                  // padding query: loads only
    const bool scaled = QUANT && ring;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      for (int t = 0; t < ps; ++t) {
        float s = score<HD>(qv[g], k_tile, t, lane) * scale;
        if (scaled) s *= ks[t];
        bool live;
        if (ring) {
          const int kpos = cur - floormod(cur - (base + t), window);
          live = kpos >= 0 && kpos > qpos - window;
        } else {
          const int j = base + t;
          const int kpos = start + j;
          live = j < n_valid && kpos <= qpos && kpos > qpos - window;
        }
        if (lane == 0) sc[g * ps + t] = live ? s : NEG_INF;
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      online_update<HD>(m[g], l[g], acc[g], sc + g * ps, v_tile,
                        scaled ? vs : nullptr, ps, lane);
    }
    __syncwarp();                           // sc reused by the next tile
  }

  if (i >= S) return;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    const float inv = active ? 1.f / fmaxf(l[g], 1e-30f) : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[row_off(g) + lane * E + e] = from_f32<T>(acc[g][e] * inv);
  }
}


template <typename T, typename PT, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* chunk_k,
           const void* chunk_v, const void* page_row, void* out, int S,
           int KV, int G, int ps, int n_table, int start, int n_valid,
           int window, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(ps) * HD +
                       static_cast<size_t>(QB) * MAXG * ps + 2 * ps) *
                      sizeof(float);
  auto kernel = paged_ring_prefill_kernel<T, PT, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KV, (S + QB - 1) / QB);
  kernel<<<grid, QB * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const T*>(chunk_k), static_cast<const T*>(chunk_v),
      static_cast<const int*>(page_row), static_cast<T*>(out), S, KV, G, ps,
      n_table, start, n_valid, window, 1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (dtype, int8 pages, head dim): bf16 to the tensor-core
// kernel, fp32 to the scalar body
template <typename PT>
int launch_hd(int dtype, int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* ck, const void* cv,
              const void* row, void* out, void* ws, int S, int KV, int G,
              int ps, int n_table, int start, int n_valid, int window,
              int splits, cudaStream_t stream) {
  if (dtype == DTYPE_BF16) {
    if (hd == 64)
      return launch_prefill_wgmma<true, PT, 64>(q, k, v, ks, vs, ck, cv, row,
                                                out, ws, S, KV, G, ps,
                                                n_table * ps, start, n_valid,
                                                window, splits, stream);
    if (hd == 128)
      return launch_prefill_wgmma<true, PT, 128>(q, k, v, ks, vs, ck, cv,
                                                 row, out, ws, S, KV, G, ps,
                                                 n_table * ps, start, n_valid,
                                                 window, splits, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  using FP = typename std::conditional<sizeof(PT) == 1, int8_t, float>::type;
  if (hd == 64)
    return launch<float, FP, 64>(q, k, v, ks, vs, ck, cv, row, out, S, KV, G,
                                 ps, n_table, start, n_valid, window, stream);
  if (hd == 128)
    return launch<float, FP, 128>(q, k, v, ks, vs, ck, cv, row, out, S, KV,
                                  G, ps, n_table, start, n_valid, window,
                                  stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

// q [S, KV, G, hd]; k/v_pages [P, ps, KV, hd] — the ring before the
// chunk's writes — in q's dtype, or int8 with k/v_scale [P, ps, KV] bf16
// (quantized = 1; null pointers otherwise); chunk_k / chunk_v [S, KV, hd]
// in q's dtype; page_row [n_table] int32, n_table * ps <= window;
// out [S, KV, G, hd].  bf16 only: `splits` > 1 splits every block's key
// tiles over blockIdx.z, with ws the fp32 workspace of splits x KV x
// rows_pad x (hd + 2) floats, rows_pad = 64 * ceil(S * G / 64) (null for
// splits = 1); fp32 takes splits = 1.  Returns the cudaError_t of the
// launches (0 = queued).
extern "C" int paged_ring_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* chunk_k,
    const void* chunk_v, const void* page_row, void* out, void* ws, int S,
    int KV, int G, int hd, int ps, int n_table, int start, int n_valid,
    int window, int dtype, int quantized, int splits, void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > MAXG || n_valid > S || S < 1 || window < 1 ||
      n_table * ps > window || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)) ||
      (dtype != DTYPE_BF16 && dtype != DTYPE_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch_hd<int8_t>(dtype, hd, q, k_pages, v_pages, k_scale,
                             v_scale, chunk_k, chunk_v, page_row, out, ws, S,
                             KV, G, ps, n_table, start, n_valid, window,
                             splits, s);
  return launch_hd<__nv_bfloat16>(dtype, hd, q, k_pages, v_pages, k_scale,
                                  v_scale, chunk_k, chunk_v, page_row, out,
                                  ws, S, KV, G, ps, n_table, start, n_valid,
                                  window, splits, s);
}
