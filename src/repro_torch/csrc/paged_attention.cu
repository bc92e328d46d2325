// Paged decode attention for Hopper (sm_90a): contiguous pages (K1), ring-
// wrapped window pages (K4), fp or int8 pages (K8).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_attention_kernel` / `_paged_kernel`: one query token per decode
// slot attends the pages its page-table row names, with an online softmax
// over pages and the output `acc / max(l, 1e-30)`.
//   * contiguous pages (window == 0): keys masked by `idx < length`, pages
//     past `length` skipped;
//   * ring pages (window > 0, K4): the row is a ring of window / ps cells;
//     cell idx holds position p = cur - floormod(cur - idx, window) with
//     cur = length - 1, and p >= 0 is the mask (it is also the sliding-
//     window mask).  Cells run to min(length, window); pages past them are
//     skipped.  The modulo is a floor modulo: on the straddling page of a
//     slot shorter than the window, cur - idx is negative, and C's `%`
//     would unmask cells that were never written;
//   * int8 pages (K8): one bf16 scale per (page, offset, kv-head) row for K
//     and for V, staged in shared memory as fp32.  Each raw score is
//     multiplied by its key's scale after the dot product and before the
//     mask; each probability by its value's scale before the PV product;
//     the denominator l is not scaled (as `_paged_kernel` does).
//
// What bounds it on an H100: bytes.  A slot reads each page it holds once
// (ps x hd bf16 for K and again for V per kv-head; half that plus 2 x ps
// scale bytes for int8 pages) and does one multiply-add per query head for
// each element it reads — G flop per byte of bf16 pages, 5 at G = 5, far
// below the ~295 flop/byte where the tensor cores would become the limit.
// So the design reads only the pages a slot holds (the paged gather
// happens in the tile load, never as a materialized [slots, n*ps] copy),
// skips pages past the slot's live cells, and reads each page from device
// memory once per (slot, kv-head) block however many query heads share it:
// one block per (slot, kv-head), one warp per query head of the GQA group,
// the tile in shared memory read by all G warps.  int8 pages halve the
// bytes.  The online-softmax state (m, l, acc) stays in registers.  No
// double buffering, no split over pages: cp.async/TMA pipelining and
// split-K are later work.
#include "paged_common.cuh"

namespace repro_torch {

template <typename T, typename PT, int HD>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const PT* __restrict__ k_pages,
                                    const PT* __restrict__ v_pages,
                                    const __nv_bfloat16* __restrict__ k_scale,
                                    const __nv_bfloat16* __restrict__ v_scale,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int KV, int G,
                                    int ps, int n_table, int window,
                                    float scale) {
  constexpr int E = HD / 32;
  constexpr bool QUANT = sizeof(PT) == 1;
  extern __shared__ float smem[];
  float* k_tile = smem;                     // [ps, HD]
  float* v_tile = k_tile + ps * HD;         // [ps, HD]
  float* scores = v_tile + ps * HD;         // [G, ps]
  float* ks = scores + G * ps;              // [ps] (int8 pages)
  float* vs = ks + ps;                      // [ps] (int8 pages)

  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int g = threadIdx.x / 32;           // query head within the group
  const int lane = threadIdx.x % 32;
  const int length = lengths[slot];
  const int cur = length - 1;               // the newest token's position
  const int* row = page_table + static_cast<int64_t>(slot) * n_table;
  float* sc = scores + g * ps;

  // q [slots, KV, G, HD]: this warp's query row, E elements per lane
  const int64_t qoff = ((static_cast<int64_t>(slot) * KV + h) * G + g) * HD;
  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = to_f32(q[qoff + lane * E + e]);

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  // cells wholly past the slot's valid tokens are skipped (never loaded);
  // on the ring the valid cells saturate at the window
  const int cells = window > 0 ? min(length, window) : length;
  const int n_pages = min(n_table, (cells + ps - 1) / ps);
  for (int p = 0; p < n_pages; ++p) {
    const int page = row[p];
    __syncthreads();                        // previous tile fully consumed
    load_tile<PT, HD>(k_tile, k_pages, page, ps, KV, h);
    load_tile<PT, HD>(v_tile, v_pages, page, ps, KV, h);
    if (QUANT) {
      load_scales(ks, k_scale, page, ps, KV, h);
      load_scales(vs, v_scale, page, ps, KV, h);
    }
    __syncthreads();
    const int base = p * ps;
    for (int t = 0; t < ps; ++t) {
      float s = score<HD>(qv, k_tile, t, lane) * scale;
      if (QUANT) s *= ks[t];
      const int idx = base + t;
      const bool live = window > 0 ? cur - floormod(cur - idx, window) >= 0
                                   : idx < length;
      if (lane == 0) sc[t] = live ? s : NEG_INF;
    }
    __syncwarp();
    online_update<HD>(m, l, acc, sc, v_tile, QUANT ? vs : nullptr, ps, lane);
    __syncwarp();                           // sc reused by the next page
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e)
    out[qoff + lane * E + e] = from_f32<T>(acc[e] * inv);
}

template <typename T, typename PT, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* lengths, void* out, int slots, int KV, int G, int ps,
           int n_table, int window, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(ps) * HD +
                       static_cast<size_t>(G) * ps + 2 * ps) * sizeof(float);
  auto kernel = paged_decode_kernel<T, PT, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(slots, KV);
  kernel<<<grid, G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<T*>(out), KV, G, ps, n_table, window,
      1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename PT>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* table,
              const void* lengths, void* out, int slots, int KV, int G,
              int ps, int n_table, int window, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, PT, 64>(q, k, v, ks, vs, table, lengths, out, slots,
                               KV, G, ps, n_table, window, stream);
    case 128:
      return launch<T, PT, 128>(q, k, v, ks, vs, table, lengths, out, slots,
                                KV, G, ps, n_table, window, stream);
    case 256:
      return launch<T, PT, 256>(q, k, v, ks, vs, table, lengths, out, slots,
                                KV, G, ps, n_table, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_pages(int quantized, int hd, const void* q, const void* k,
                 const void* v, const void* ks, const void* vs,
                 const void* table, const void* lengths, void* out,
                 int slots, int KV, int G, int ps, int n_table, int window,
                 cudaStream_t stream) {
  if (quantized)
    return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, table, lengths, out,
                                slots, KV, G, ps, n_table, window, stream);
  return launch_hd<T, T>(hd, q, k, v, ks, vs, table, lengths, out, slots,
                         KV, G, ps, n_table, window, stream);
}

}  // namespace repro_torch

// q [slots, KV, G, hd]; k/v_pages [P, ps, KV, hd] in q's dtype, or int8
// with k/v_scale [P, ps, KV] bf16 (quantized = 1; null pointers
// otherwise); page_table [slots, n_table] int32; lengths [slots] int32;
// window 0 (contiguous) or the ring's window; out [slots, KV, G, hd].
// Returns the cudaError_t of the launch (0 = queued).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* k_scale,
                                      const void* v_scale,
                                      const void* page_table,
                                      const void* lengths, void* out,
                                      int slots, int KV, int G, int hd,
                                      int ps, int n_table, int window,
                                      int dtype, int quantized,
                                      void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > 32 || window < 0 ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_pages<__nv_bfloat16>(quantized, hd, q, k_pages, v_pages,
                                       k_scale, v_scale, page_table, lengths,
                                       out, slots, KV, G, ps, n_table,
                                       window, s);
  if (dtype == DTYPE_F32)
    return launch_pages<float>(quantized, hd, q, k_pages, v_pages, k_scale,
                               v_scale, page_table, lengths, out, slots, KV,
                               G, ps, n_table, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
