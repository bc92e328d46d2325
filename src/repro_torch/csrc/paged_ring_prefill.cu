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
// denominator unscaled; the chunk operands are fp (scale 1).  The modulo
// is a floor modulo: for start < window the cells at or past start have
// cur - idx < 0, and C's `%` would unmask them.
//
// What bounds it on an H100: at serving shapes (verify rows of S = 5 and
// prefill chunks up to S = 1024 against a 4096-token ring), a block of
// QB = 8 queries x G heads reads the ring once and does G * QB multiply-
// adds per element it reads — ~48 flop per byte of bf16 pages at G = 6,
// under the ~295 flop/byte ridge, so bytes bound one block; across the
// S / QB blocks of a long chunk the ring is read again by every block, and
// the scalar FMAs, not the bytes, take the time.  The design is K2's: one
// block per (kv-head, QB queries), one warp per query holding the fp32
// online-softmax state of its G <= 8 heads in registers, each ring page or
// ps-row chunk tile loaded once into shared memory for all QB x G rows.
// Chunk tiles past the block's last query are skipped.  wgmma tiles over
// many queries, and TMA, are later work.
#include "paged_common.cuh"

namespace repro_torch {

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

template <typename T, typename PT>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* ck, const void* cv,
              const void* row, void* out, int S, int KV, int G, int ps,
              int n_table, int start, int n_valid, int window,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, PT, 64>(q, k, v, ks, vs, ck, cv, row, out, S, KV, G,
                               ps, n_table, start, n_valid, window, stream);
    case 128:
      return launch<T, PT, 128>(q, k, v, ks, vs, ck, cv, row, out, S, KV, G,
                                ps, n_table, start, n_valid, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_pages(int quantized, int hd, const void* q, const void* k,
                 const void* v, const void* ks, const void* vs,
                 const void* ck, const void* cv, const void* row, void* out,
                 int S, int KV, int G, int ps, int n_table, int start,
                 int n_valid, int window, cudaStream_t stream) {
  if (quantized)
    return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, ck, cv, row, out, S, KV,
                                G, ps, n_table, start, n_valid, window,
                                stream);
  return launch_hd<T, T>(hd, q, k, v, ks, vs, ck, cv, row, out, S, KV, G,
                         ps, n_table, start, n_valid, window, stream);
}

}  // namespace repro_torch

// q [S, KV, G, hd]; k/v_pages [P, ps, KV, hd] — the ring before the
// chunk's writes — in q's dtype, or int8 with k/v_scale [P, ps, KV] bf16
// (quantized = 1; null pointers otherwise); chunk_k / chunk_v [S, KV, hd]
// in q's dtype; page_row [n_table] int32, n_table * ps <= window;
// out [S, KV, G, hd].  Returns the cudaError_t of the launch (0 = queued).
extern "C" int paged_ring_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* chunk_k,
    const void* chunk_v, const void* page_row, void* out, int S, int KV,
    int G, int hd, int ps, int n_table, int start, int n_valid, int window,
    int dtype, int quantized, void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > MAXG || n_valid > S || S < 1 || window < 1 ||
      n_table * ps > window ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_pages<__nv_bfloat16>(quantized, hd, q, k_pages, v_pages,
                                       k_scale, v_scale, chunk_k, chunk_v,
                                       page_row, out, S, KV, G, ps, n_table,
                                       start, n_valid, window, s);
  if (dtype == DTYPE_F32)
    return launch_pages<float>(quantized, hd, q, k_pages, v_pages, k_scale,
                               v_scale, chunk_k, chunk_v, page_row, out, S,
                               KV, G, ps, n_table, start, n_valid, window,
                               s);
  return static_cast<int>(cudaErrorInvalidValue);
}
