// Paged chunked-prefill and verify attention for Hopper (sm_90a),
// contiguous pages, fp (K2) or int8 (K8).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_prefill_kernel` / `_paged_prefill_kernel` (its int8 branch is
// K8): one request's bucketed chunk of S queries (query i at absolute
// position start + i) attends that request's pages after the chunk's own
// K/V were written.  Key kidx is valid for query i when kidx < start +
// n_valid (the written bound) and kidx <= start + i (causal).  Rows at or
// past n_valid come back 0; a tile of padding rows touches no page.  int8
// pages carry one bf16 scale per (page, offset, kv-head) row: raw scores
// times the key scale after the softmax scale and before the mask,
// probabilities times the value scale before the PV product, the
// denominator unscaled.
//
// What bounds it on an H100: bytes, at qwen2.5-14b's shapes (KV 8, G 5,
// hd 128, ps 16), as chip_smoke.py's K2 cases count them.  A verify
// (S = 5) after 37 keys moves ~0.27 MB of pages, q and out: 0.08 us at
// 3.35 TB/s (2.4 MFLOP); after 480 keys ~2 MB, 0.6 us.  A 256-query
// prefill bucket after a 48-token prefix keeps ~0.9 GFLOP of causal pairs
// (0.9 us at 989 TFLOP/s) against 6.5 MB of q, out and pages (1.9 us).
// The first port (one block per (kv-head, 8 queries), a warp-shuffle dot
// product per (head, key), fp32 tiles, 8 blocks for a verify) ran
// 100-1000x above the bound and up to 22x SDPA's device time.
//
// The bf16 design, for hd 64 and 128, is the tensor-core body K5 runs
// (paged_prefill_body.cuh, RING = false): rows r = i * G + g in 64-row
// tiles, one warpgroup each, so a verify's 25 rows share one tile and a
// tile may straddle queries (each row carries its own position); keys
// walked by position from 0 to one past the tile's last valid query,
// position p at row p % ps of page page_row[p / ps] (no ring arithmetic,
// no chunk operand: the pages already hold the chunk), in 64-key tiles
// gathered by cp.async into 128-byte-swizzled shared memory and
// double-buffered; Q K^T and P V on wgmma (P as hi + lo bf16 operands:
// bf16 P alone moves outputs by a bf16 ulp); masks only on the causal
// diagonal (the written bound follows from it for every valid row); int8
// rows land in a staging buffer and widen exactly (byte permutes) while
// P V runs.  A verify or a short bucket is only 8-16 warpgroups, so the
// wrapper splits key tiles over blockIdx.z (`prefill_splits`, a function
// of the shapes) and a second kernel merges the fp32 partials as
// merge_partials_ref does: the long-prefix verify (start 480) runs 64
// blocks instead of 8.
//
// fp32, and hd 256 in bf16, keep the scalar body of the first port,
// chosen explicitly by dtype and head dim (no served model runs K2 at hd
// 256: recurrentgemma's hd-256 attention is on the slotted pool): one
// block per (kv-head, 8 queries), one warp per query, each warp holding
// the fp32 online-softmax state of all G heads of its query.  It is what
// the fp32 arms run (TF32 tensor cores would spend their 1e-3 margin).
#include "paged_prefill_body.cuh"

namespace repro_torch {

constexpr int QB = 8;          // queries per block = warps per block
constexpr int MAXG = 8;        // largest GQA group the kernel holds

template <typename T, typename PT, int HD>
__global__ void paged_prefill_kernel(const T* __restrict__ q,
                                     const PT* __restrict__ k_pages,
                                     const PT* __restrict__ v_pages,
                                     const __nv_bfloat16* __restrict__ k_scale,
                                     const __nv_bfloat16* __restrict__ v_scale,
                                     const int* __restrict__ page_row,
                                     T* __restrict__ out, int S, int KV,
                                     int G, int ps, int n_table, int start,
                                     int n_valid, float scale) {
  constexpr int E = HD / 32;
  constexpr bool QUANT = sizeof(PT) == 1;
  extern __shared__ float smem[];
  float* k_tile = smem;                     // [ps, HD]
  float* v_tile = k_tile + ps * HD;         // [ps, HD]
  float* scores = v_tile + ps * HD;         // [QB, MAXG, ps]
  float* ks = scores + QB * MAXG * ps;      // [ps] (int8 pages)
  float* vs = ks + ps;                      // [ps] (int8 pages)

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
  const int limit = start + n_valid;        // keys written so far
  const int horizon = min(limit, start + q0 + QB);
  const int qlimit = min(limit, start + i + 1);   // this query's keys

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

  const int n_pages = min(n_table, (horizon + ps - 1) / ps);
  for (int p = 0; p < n_pages; ++p) {
    const int page = page_row[p];
    __syncthreads();                        // previous tile fully consumed
    load_tile<PT, HD>(k_tile, k_pages, page, ps, KV, h);
    load_tile<PT, HD>(v_tile, v_pages, page, ps, KV, h);
    if (QUANT) {
      load_scales(ks, k_scale, page, ps, KV, h);
      load_scales(vs, v_scale, page, ps, KV, h);
    }
    __syncthreads();
    if (!active) continue;                  // padding query: loads only
    const int base = p * ps;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      for (int t = 0; t < ps; ++t) {
        float s = score<HD>(qv[g], k_tile, t, lane) * scale;
        if (QUANT) s *= ks[t];
        if (lane == 0) sc[g * ps + t] = (base + t < qlimit) ? s : NEG_INF;
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      online_update<HD>(m[g], l[g], acc[g], sc + g * ps, v_tile,
                        QUANT ? vs : nullptr, ps, lane);
    }
    __syncwarp();                           // sc reused by the next page
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
           const void* k_scale, const void* v_scale, const void* page_row,
           void* out, int S, int KV, int G, int ps, int n_table, int start,
           int n_valid, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(ps) * HD +
                       static_cast<size_t>(QB) * MAXG * ps + 2 * ps) *
                      sizeof(float);
  auto kernel = paged_prefill_kernel<T, PT, HD>;
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
      static_cast<const int*>(page_row), static_cast<T*>(out), S, KV, G, ps,
      n_table, start, n_valid, 1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename PT>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* row, void* out,
              void* ws, int S, int KV, int G, int ps, int n_table, int start,
              int n_valid, int splits, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (hd == 64)
      return launch_prefill_wgmma<false, PT, 64>(
          q, k, v, ks, vs, nullptr, nullptr, row, out, ws, S, KV, G, ps,
          n_table * ps, start, n_valid, 0, splits, stream);
    if (hd == 128)
      return launch_prefill_wgmma<false, PT, 128>(
          q, k, v, ks, vs, nullptr, nullptr, row, out, ws, S, KV, G, ps,
          n_table * ps, start, n_valid, 0, splits, stream);
    if (hd == 256 && splits == 1)
      return launch<T, PT, 256>(q, k, v, ks, vs, row, out, S, KV, G, ps,
                                n_table, start, n_valid, stream);
  } else if (splits == 1) {
    if (hd == 64)
      return launch<T, PT, 64>(q, k, v, ks, vs, row, out, S, KV, G, ps,
                               n_table, start, n_valid, stream);
    if (hd == 128)
      return launch<T, PT, 128>(q, k, v, ks, vs, row, out, S, KV, G, ps,
                                n_table, start, n_valid, stream);
    if (hd == 256)
      return launch<T, PT, 256>(q, k, v, ks, vs, row, out, S, KV, G, ps,
                                n_table, start, n_valid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_pages(int quantized, int hd, const void* q, const void* k,
                 const void* v, const void* ks, const void* vs,
                 const void* row, void* out, void* ws, int S, int KV, int G,
                 int ps, int n_table, int start, int n_valid, int splits,
                 cudaStream_t stream) {
  if (quantized)
    return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, row, out, ws, S, KV, G,
                                ps, n_table, start, n_valid, splits, stream);
  return launch_hd<T, T>(hd, q, k, v, ks, vs, row, out, ws, S, KV, G, ps,
                         n_table, start, n_valid, splits, stream);
}

}  // namespace repro_torch

// q [S, KV, G, hd]; k/v_pages [P, ps, KV, hd] in q's dtype, or int8 with
// k/v_scale [P, ps, KV] bf16 (quantized = 1; null pointers otherwise);
// page_row [n_table] int32; out [S, KV, G, hd]; start / n_valid as in the
// header note, start + n_valid <= n_table * ps.  bf16 at hd 64 / 128 only:
// `splits` > 1 splits every block's key tiles over blockIdx.z, with ws the
// fp32 workspace of splits x KV x rows_pad x (hd + 2) floats, rows_pad =
// 64 * ceil(S * G / 64) (null for splits = 1); the scalar body takes
// splits = 1.  Returns the cudaError_t of the launches (0 = queued).
extern "C" int paged_prefill_launch(const void* q, const void* k_pages,
                                    const void* v_pages, const void* k_scale,
                                    const void* v_scale,
                                    const void* page_row, void* out,
                                    void* ws, int S, int KV, int G, int hd,
                                    int ps, int n_table, int start,
                                    int n_valid, int dtype, int quantized,
                                    int splits, void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > MAXG || n_valid > S || S < 1 || splits < 1 ||
      splits > 65535 || (splits > 1 && ws == nullptr) ||
      start + n_valid > n_table * ps ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_pages<__nv_bfloat16>(quantized, hd, q, k_pages, v_pages,
                                       k_scale, v_scale, page_row, out, ws,
                                       S, KV, G, ps, n_table, start, n_valid,
                                       splits, s);
  if (dtype == DTYPE_F32)
    return launch_pages<float>(quantized, hd, q, k_pages, v_pages, k_scale,
                               v_scale, page_row, out, ws, S, KV, G, ps,
                               n_table, start, n_valid, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
