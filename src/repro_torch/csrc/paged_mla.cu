// Absorbed-MLA paged decode (K6) for Hopper (sm_90a), latent pages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_mla_kernel` / `_paged_mla_kernel`: one query token per decode
// slot, all H heads absorbed through W_uk into the latent space (q_lat
// [slots, H, R], q_rope [slots, H, rp]), attends the ckv [P, ps, R] and
// krope [P, ps, rp] pages its page-table row names, with an online softmax
// over pages, keys masked by `tok < length`, and the latent output
// `acc / max(l, 1e-30)` [slots, H, R] in q's dtype (the caller
// up-projects through W_uv).  The softmax scale is an argument: it is the
// qk-dimension scale (qk_nope + qk_rope) ** -0.5, not R ** -0.5.
//
// What bounds it on an H100: bytes.  A slot reads each latent page it
// holds once, sum_s ceil(L_s / ps) * ps * (R + rp) * 2 bytes in bf16, and
// does 2 * H * (2R + rp) flop per key — at H = 16 about 32 flop per byte,
// well under the ~295 flop/byte where the tensor cores would become the
// limit.  What the design does about it: every head reads the same latent
// page, so one block per slot holds all H heads and each page crosses from
// device memory into shared memory once per slot (not once per head, as an
// expanded per-head cache would); pages past the slot's length are never
// loaded; the [H, R] accumulator stays in registers
// (paged_mla_common.cuh).  Only `slots` blocks are in flight (8 in the
// serving drive), so the kernel is latency-bound at small batch; a split
// over pages (flash-decoding) is the next step, not this kernel's.
#include "paged_mla_common.cuh"

namespace repro_torch {

template <typename T, int H, int R, int RP>
__global__ void __launch_bounds__(MLA_THREADS)
paged_mla_decode_kernel(const T* __restrict__ q_lat,
                        const T* __restrict__ q_rope,
                        const T* __restrict__ ckv_pages,
                        const T* __restrict__ krope_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int ps, int n_table, float scale) {
  const int64_t s = blockIdx.x;
  mla_attend<T, H, R, RP>(q_lat + s * H * R, q_rope + s * H * RP, ckv_pages,
                          krope_pages, page_table + s * n_table, n_table, ps,
                          lengths[s], scale, out + s * H * R);
}

template <typename T, int H, int R, int RP>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* page_table, const void* lengths,
           void* out, int slots, int ps, int n_table, float scale,
           cudaStream_t stream) {
  const size_t smem = MlaGeom<H, R, RP>::smem_floats(ps) * sizeof(float);
  auto kernel = paged_mla_decode_kernel<T, H, R, RP>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<slots, MLA_THREADS, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<T*>(out), ps, n_table, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_geom(int H, int R, int RP, const void* q_lat, const void* q_rope,
                const void* ckv, const void* krope, const void* table,
                const void* lengths, void* out, int slots, int ps,
                int n_table, float scale, cudaStream_t stream) {
  if (H == 16 && R == 512 && RP == 64)     // deepseek-v2-lite, full width
    return launch<T, 16, 512, 64>(q_lat, q_rope, ckv, krope, table, lengths,
                                  out, slots, ps, n_table, scale, stream);
  if (H == 4 && R == 32 && RP == 8)        // the smoke geometry
    return launch<T, 4, 32, 8>(q_lat, q_rope, ckv, krope, table, lengths,
                               out, slots, ps, n_table, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

// q_lat [slots, H, R]; q_rope [slots, H, rp]; ckv_pages [P, ps, R];
// krope_pages [P, ps, rp]; page_table [slots, n_table] int32; lengths
// [slots] int32; out [slots, H, R].  Returns the cudaError_t of the launch
// (0 = queued).
extern "C" int paged_mla_launch(const void* q_lat, const void* q_rope,
                                const void* ckv_pages,
                                const void* krope_pages,
                                const void* page_table, const void* lengths,
                                void* out, int slots, int H, int R, int rp,
                                int ps, int n_table, float scale, int dtype,
                                void* stream) {
  using namespace repro_torch;
  if (ps < 8 || ps > 64 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_geom<__nv_bfloat16>(H, R, rp, q_lat, q_rope, ckv_pages,
                                      krope_pages, page_table, lengths, out,
                                      slots, ps, n_table, scale, s);
  if (dtype == DTYPE_F32)
    return launch_geom<float>(H, R, rp, q_lat, q_rope, ckv_pages,
                              krope_pages, page_table, lengths, out, slots,
                              ps, n_table, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
