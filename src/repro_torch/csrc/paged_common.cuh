// Device helpers shared by the paged-attention kernels (decode and chunked
// prefill, contiguous and ring pages).  k/v pages are [P, ps, KV, hd] in
// the compute dtype (bf16 or fp32) or int8 with one bf16 scale per
// (page, offset, kv-head) row ([P, ps, KV]); every score, softmax
// statistic and accumulator is fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// -0.7 * FLT_MAX: finite, so exp(NEG_INF - m) is exactly 0 and a fully
// masked row stays finite (its output is 0 / max(l, 1e-30) = 0, not NaN).
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

// dtype codes passed by the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// Floor modulo for b > 0: the result has b's sign, as jnp.mod and
// torch.remainder.  C's % truncates toward zero, so for a < 0 it returns a
// negative remainder — on a ring slot shorter than the window that would
// turn the never-written cells' positions non-negative and unmask them.
__device__ __forceinline__ int floormod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy n_rows rows of HD elements into shared memory as fp32, 16 bytes per
// thread per step; row t starts at src + t * stride (elements).  Rows at or
// past n_valid are zero-filled (a ragged chunk tile).  All threads of the
// block take part; the caller fences with __syncthreads().
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t stride, int n_rows,
                                          int n_valid) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int PER_ROW = HD / VEC;
  const int n = n_rows * PER_ROW;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    float* d = dst + t * HD + c;
    if (t >= n_valid) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = 0.f;
      continue;
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(src + t * stride + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) d[e] = to_f32(vals[e]);
  }
}

// Copy one page's [ps, HD] tile of kv-head h into shared memory as fp32
// (rows are contiguous HD-element runs; the page's rows sit KV*HD elements
// apart).  T is the page type: the compute dtype, or int8_t.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* pages,
                                          int page, int ps, int KV, int h) {
  load_rows<T, HD>(dst,
                   pages + (static_cast<int64_t>(page) * ps * KV + h) * HD,
                   static_cast<int64_t>(KV) * HD, ps, ps);
}

// Copy one page's [ps] bf16 scales of kv-head h (int8 pages) into shared
// memory, widened to fp32.
__device__ __forceinline__ void load_scales(float* dst,
                                            const __nv_bfloat16* scale,
                                            int page, int ps, int KV, int h) {
  for (int t = threadIdx.x; t < ps; t += blockDim.x)
    dst[t] = __bfloat162float(
        scale[(static_cast<int64_t>(page) * ps + t) * KV + h]);
}

// Score of one query (E = HD/32 elements per lane, already in registers)
// against key row t of a shared tile; every lane gets the full sum.
template <int HD>
__device__ __forceinline__ float score(const float (&q)[HD / 32],
                                       const float* k_tile, int t,
                                       int lane) {
  constexpr int E = HD / 32;
  const float* kr = k_tile + t * HD + lane * E;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += q[e] * kr[e];
  return warp_sum(s);
}

// Fold one page's masked scores sc[0..ps) into the online-softmax state
// (m, l, acc) of one query row; acc holds this lane's E output elements.
// vs (int8 pages; nullptr otherwise) scales each probability by its value
// row's scale before the PV product; the denominator l stays unscaled.
template <int HD>
__device__ __forceinline__ void online_update(float& m, float& l,
                                              float (&acc)[HD / 32],
                                              const float* sc,
                                              const float* v_tile,
                                              const float* vs, int ps,
                                              int lane) {
  constexpr int E = HD / 32;
  float mx = NEG_INF;
  for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[t]);
  const float m_new = fmaxf(m, mx);
  const float corr = expf(m - m_new);
  l *= corr;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] *= corr;
  for (int t = 0; t < ps; ++t) {
    const float p = expf(sc[t] - m_new);
    l += p;
    const float pv = vs ? p * vs[t] : p;
    const float* vr = v_tile + t * HD + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += pv * vr[e];
  }
  m = m_new;
}

}  // namespace repro_torch
