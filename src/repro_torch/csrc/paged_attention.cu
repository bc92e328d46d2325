// Paged decode attention for Hopper (sm_90a), contiguous fp pages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_attention_kernel` / `_paged_kernel` (window=0, fp pages): one
// query token per decode slot attends the pages its page-table row names,
// with an online softmax over pages, keys masked by `idx < length`, pages
// past `length` skipped, and the output `acc / max(l, 1e-30)`.
//
// What bounds it on an H100: bytes.  A slot reads each page it holds once
// (ps x hd bf16 for K and again for V per kv-head) and does one
// multiply-add per query head for each element it reads — G flop per byte
// of bf16 pages, 5 at G = 5, far below the ~295 flop/byte where the
// tensor cores would become the limit.  So the
// design reads only the pages a slot holds (the paged gather happens in
// the tile load, never as a materialized [slots, n*ps] copy), skips pages
// past the slot's length, and reads each page from device memory once per
// (slot, kv-head) block however many query heads share it: one block per
// (slot, kv-head), one warp per query head of the GQA group, the tile in
// shared memory read by all G warps.  The online-softmax state (m, l, acc)
// stays in registers.  No double buffering, no split over pages: the first
// port is simple and right; cp.async/TMA pipelining and split-K are later
// work.
#include "paged_common.cuh"

namespace repro_torch {

template <typename T, int HD>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int KV, int G,
                                    int ps, int n_table, float scale) {
  constexpr int E = HD / 32;
  extern __shared__ float smem[];
  float* k_tile = smem;                     // [ps, HD]
  float* v_tile = k_tile + ps * HD;         // [ps, HD]
  float* scores = v_tile + ps * HD;         // [G, ps]

  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int g = threadIdx.x / 32;           // query head within the group
  const int lane = threadIdx.x % 32;
  const int length = lengths[slot];
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

  // pages wholly past the slot's valid tokens are skipped (never loaded)
  const int n_pages = min(n_table, (length + ps - 1) / ps);
  for (int p = 0; p < n_pages; ++p) {
    const int page = row[p];
    __syncthreads();                        // previous tile fully consumed
    load_tile<T, HD>(k_tile, k_pages, page, ps, KV, h);
    load_tile<T, HD>(v_tile, v_pages, page, ps, KV, h);
    __syncthreads();
    const int base = p * ps;
    for (int t = 0; t < ps; ++t) {
      const float s = score<HD>(qv, k_tile, t, lane) * scale;
      if (lane == 0) sc[t] = (base + t < length) ? s : NEG_INF;
    }
    __syncwarp();
    online_update<HD>(m, l, acc, sc, v_tile, ps, lane);
    __syncwarp();                           // sc reused by the next page
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e)
    out[qoff + lane * E + e] = from_f32<T>(acc[e] * inv);
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* out,
           int slots, int KV, int G, int ps, int n_table,
           cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(ps) * HD +
                       static_cast<size_t>(G) * ps) * sizeof(float);
  auto kernel = paged_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(slots, KV);
  kernel<<<grid, G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), KV, G, ps,
      n_table, 1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* table, const void* lengths, void* out, int slots,
              int KV, int G, int ps, int n_table, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, table, lengths, out, slots, KV, G, ps,
                           n_table, stream);
    case 128:
      return launch<T, 128>(q, k, v, table, lengths, out, slots, KV, G, ps,
                            n_table, stream);
    case 256:
      return launch<T, 256>(q, k, v, table, lengths, out, slots, KV, G, ps,
                            n_table, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

// q [slots, KV, G, hd]; k/v_pages [P, ps, KV, hd]; page_table [slots,
// n_table] int32; lengths [slots] int32; out [slots, KV, G, hd].  Returns
// the cudaError_t of the launch (0 = queued).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* lengths, void* out,
                                      int slots, int KV, int G, int hd,
                                      int ps, int n_table, int dtype,
                                      void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, page_table,
                                    lengths, out, slots, KV, G, ps, n_table,
                                    s);
  if (dtype == DTYPE_F32)
    return launch_hd<float>(hd, q, k_pages, v_pages, page_table, lengths,
                            out, slots, KV, G, ps, n_table, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
