// Absorbed-MLA chunked prefill and speculative verify (K7) for Hopper
// (sm_90a), latent pages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_mla_prefill_kernel` / `_paged_mla_prefill_kernel`: one request's
// bucketed chunk of S queries (query i at absolute position start + i),
// absorbed through W_uk (q_lat [S, H, R], q_rope [S, H, rp]), attends the
// ckv / krope pages of its one page row after the chunk's own latents were
// written.  Key kidx is valid for query i when kidx < start + n_valid (the
// written bound) and kidx <= start + i (causal), so query i's keys are the
// first start + i + 1.  The output is the latent [S, H, R] in q's dtype.
// Queries that are bucket padding (i >= n_valid) write zeros and return
// without touching a page — the Pallas kernel skips all-padding query
// blocks the same way; callers never read those rows.
//
// What bounds it on an H100: at the serving shapes (S = 5 verify rows,
// S = 16..64 prefill buckets) bytes — the latent pages up to the chunk's
// horizon, (start + n_valid) * (R + rp) * 2 bytes in bf16, against
// 2 * H * (2R + rp) flop per (query, key) pair; for long chunks the
// operations (see chip_smoke.py's bound for each case).  What the design
// does about it: one block per query holding all H heads, so a latent page
// is read into shared memory once per query and feeds every head; each
// block stops at its own causal horizon, so a query never loads a page
// past start + i; the [H, R] accumulator stays in registers
// (paged_mla_common.cuh).  Blocks of one chunk re-read the shared prefix
// pages (from L2 after the first); tensor-core tiles over several queries
// per block are the next step.
#include "paged_mla_common.cuh"

namespace repro_torch {

template <typename T, int H, int R, int RP>
__global__ void __launch_bounds__(MLA_THREADS)
paged_mla_prefill_kernel(const T* __restrict__ q_lat,
                         const T* __restrict__ q_rope,
                         const T* __restrict__ ckv_pages,
                         const T* __restrict__ krope_pages,
                         const int* __restrict__ page_row,
                         T* __restrict__ out, int ps, int n_table, int start,
                         int n_valid, float scale) {
  const int i = blockIdx.x;
  T* o = out + static_cast<int64_t>(i) * H * R;
  if (i >= n_valid) {                      // bucket padding: emit 0
    for (int e = threadIdx.x; e < H * R; e += blockDim.x)
      o[e] = from_f32<T>(0.f);
    return;
  }
  mla_attend<T, H, R, RP>(q_lat + static_cast<int64_t>(i) * H * R,
                          q_rope + static_cast<int64_t>(i) * H * RP,
                          ckv_pages, krope_pages, page_row, n_table, ps,
                          start + i + 1, scale, o);
}

template <typename T, int H, int R, int RP>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* page_row, void* out, int S, int ps,
           int n_table, int start, int n_valid, float scale,
           cudaStream_t stream) {
  const size_t smem = MlaGeom<H, R, RP>::smem_floats(ps) * sizeof(float);
  auto kernel = paged_mla_prefill_kernel<T, H, R, RP>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<S, MLA_THREADS, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<const int*>(page_row), static_cast<T*>(out), ps, n_table,
      start, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_geom(int H, int R, int RP, const void* q_lat, const void* q_rope,
                const void* ckv, const void* krope, const void* row,
                void* out, int S, int ps, int n_table, int start,
                int n_valid, float scale, cudaStream_t stream) {
  if (H == 16 && R == 512 && RP == 64)     // deepseek-v2-lite, full width
    return launch<T, 16, 512, 64>(q_lat, q_rope, ckv, krope, row, out, S,
                                  ps, n_table, start, n_valid, scale,
                                  stream);
  if (H == 4 && R == 32 && RP == 8)        // the smoke geometry
    return launch<T, 4, 32, 8>(q_lat, q_rope, ckv, krope, row, out, S, ps,
                               n_table, start, n_valid, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

// q_lat [S, H, R]; q_rope [S, H, rp]; ckv_pages [P, ps, R]; krope_pages
// [P, ps, rp]; page_row [n_table] int32; out [S, H, R]; start / n_valid as
// in the header note.  Returns the cudaError_t of the launch (0 = queued).
extern "C" int paged_mla_prefill_launch(const void* q_lat, const void* q_rope,
                                        const void* ckv_pages,
                                        const void* krope_pages,
                                        const void* page_row, void* out,
                                        int S, int H, int R, int rp, int ps,
                                        int n_table, int start, int n_valid,
                                        float scale, int dtype,
                                        void* stream) {
  using namespace repro_torch;
  if (ps < 8 || ps > 64 || S < 1 || n_valid > S || n_valid < 0 || start < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_geom<__nv_bfloat16>(H, R, rp, q_lat, q_rope, ckv_pages,
                                      krope_pages, page_row, out, S, ps,
                                      n_table, start, n_valid, scale, s);
  if (dtype == DTYPE_F32)
    return launch_geom<float>(H, R, rp, q_lat, q_rope, ckv_pages,
                              krope_pages, page_row, out, S, ps, n_table,
                              start, n_valid, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
