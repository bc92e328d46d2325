// Device body shared by the fp32 absorbed-MLA paged kernels (K6 decode in
// paged_mla.cu, K7 chunked prefill and verify in paged_mla_prefill.cu;
// their bf16 kernels run on the tensor cores).
//
// One block attends ONE query token with all H heads against latent pages:
// ckv pages [P, ps, R] and krope pages [P, ps, rp] in the compute dtype
// (bf16 or fp32), one page-table row naming the pages.  Every head reads
// the same latent page, so each page is copied into shared memory once
// (16-byte global loads, widened to fp32) and feeds all H heads:
//
//   scores  s[h, j] = (q_lat[h] . ckv[j] + q_rope[h] . krope[j]) * scale,
//           masked to NEG_INF for key j >= length;
//   softmax online over pages: (m, l) per head in shared memory;
//   output  acc[h, :] = sum_j p[h, j] * ckv[j, :] — the latent space; the
//           caller up-projects through W_uv.
//
// Thread layout (NT = 256 threads): scores are one (R + rp)-long dot
// product per thread, one thread per (head, key) pair of the page; the
// accumulator [H, R] stays in registers — thread t owns columns
// c = t % COLS + COLS * i (i < R / COLS) of heads h = t / COLS +
// HEAD_THREADS * k, with COLS = min(R, NT).  At full width (H 16, R 512)
// that is 2 columns x 16 heads = 32 fp32 registers a thread.  Tiles are
// stored with one float of row padding so the score loop's threads, which
// walk different keys at the same column, hit different banks.
#pragma once

#include "paged_common.cuh"

namespace repro_torch {

constexpr int MLA_THREADS = 256;

template <int H, int R, int RP>
struct MlaGeom {
  static constexpr int COLS = R < MLA_THREADS ? R : MLA_THREADS;
  static constexpr int HEAD_THREADS = MLA_THREADS / COLS;
  static constexpr int CPT = R / COLS;                     // columns a thread
  static constexpr int HPT = (H + HEAD_THREADS - 1) / HEAD_THREADS;  // heads
  static constexpr int CKV_STRIDE = R + 1;                 // padded rows
  static constexpr int KR_STRIDE = RP + 1;
  static constexpr int Q_STRIDE = R + RP + 1;
  static_assert(R % COLS == 0, "R must tile the thread block");
  static_assert(MLA_THREADS % COLS == 0, "COLS must divide the block");

  // shared-memory floats for page size ps
  static size_t smem_floats(int ps) {
    return static_cast<size_t>(ps) * CKV_STRIDE +
           static_cast<size_t>(ps) * KR_STRIDE +
           static_cast<size_t>(H) * Q_STRIDE +
           static_cast<size_t>(H) * ps + 3 * H;
  }
};

// Copy `rows` rows of W contiguous elements (row r at src + r * W) into a
// padded fp32 shared tile (row r at dst + r * stride), 16 bytes a thread
// per step.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const T* src, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(W % VEC == 0, "rows must be whole 16-byte vectors");
  constexpr int PER_ROW = W / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r) * W + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * stride + c;
#pragma unroll
    for (int e = 0; e < VEC; ++e) d[e] = to_f32(vals[e]);
  }
}

// Attend one query token (q_lat [H, R], q_rope [H, RP] rows) with all H
// heads over the first `length` keys named by `table` (n_table entries),
// and write the latent output out [H, R].  length <= 0 writes zeros.
// Called by every thread of a block of MLA_THREADS threads.
template <typename T, int H, int R, int RP>
__device__ void mla_attend(const T* __restrict__ q_lat,
                           const T* __restrict__ q_rope,
                           const T* __restrict__ ckv_pages,
                           const T* __restrict__ krope_pages,
                           const int* __restrict__ table, int n_table,
                           int ps, int length, float scale,
                           T* __restrict__ out) {
  using Gm = MlaGeom<H, R, RP>;
  extern __shared__ float smem[];
  float* ckv = smem;                                   // [ps, R + 1]
  float* kr = ckv + ps * Gm::CKV_STRIDE;               // [ps, RP + 1]
  float* q = kr + ps * Gm::KR_STRIDE;                  // [H, R + RP + 1]
  float* sc = q + H * Gm::Q_STRIDE;                    // [H, ps]
  float* m_s = sc + H * ps;                            // [H]
  float* l_s = m_s + H;                                // [H]
  float* corr_s = l_s + H;                             // [H]

  const int tid = threadIdx.x;
  const int ct = tid % Gm::COLS;
  const int ht = tid / Gm::COLS;

  for (int i = tid; i < H * (R + RP); i += blockDim.x) {
    const int h = i / (R + RP);
    const int c = i % (R + RP);
    q[h * Gm::Q_STRIDE + c] = c < R ? to_f32(q_lat[h * R + c])
                                    : to_f32(q_rope[h * RP + (c - R)]);
  }
  if (tid < H) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[Gm::HPT][Gm::CPT];
#pragma unroll
  for (int k = 0; k < Gm::HPT; ++k)
#pragma unroll
    for (int i = 0; i < Gm::CPT; ++i) acc[k][i] = 0.f;

  // pages wholly past the query's keys are never loaded
  const int n_pages = length > 0 ? min(n_table, (length + ps - 1) / ps) : 0;
  for (int p = 0; p < n_pages; ++p) {
    const int64_t page = table[p];
    __syncthreads();                       // previous tile fully consumed
    load_rows<T, R>(ckv, Gm::CKV_STRIDE, ckv_pages + page * ps * R, ps);
    load_rows<T, RP>(kr, Gm::KR_STRIDE, krope_pages + page * ps * RP, ps);
    __syncthreads();

    // scores: one (head, key) pair a thread
    const int base = p * ps;
    for (int i = tid; i < H * ps; i += blockDim.x) {
      const int h = i / ps;
      const int j = i % ps;
      const float* qh = q + h * Gm::Q_STRIDE;
      const float* cj = ckv + j * Gm::CKV_STRIDE;
      const float* kj = kr + j * Gm::KR_STRIDE;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < R; ++c) s += qh[c] * cj[c];
#pragma unroll
      for (int c = 0; c < RP; ++c) s += qh[R + c] * kj[c];
      sc[i] = (base + j < length) ? s * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax statistics, one thread a head; sc becomes p
    if (tid < H) {
      float* row = sc + tid * ps;
      float mx = NEG_INF;
      for (int j = 0; j < ps; ++j) mx = fmaxf(mx, row[j]);
      const float m_old = m_s[tid];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float e = expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      corr_s[tid] = corr;
    }
    __syncthreads();

    // acc[h, c] = acc[h, c] * corr[h] + sum_j p[h, j] * ckv[j, c]
#pragma unroll
    for (int k = 0; k < Gm::HPT; ++k) {
      const int h = ht + Gm::HEAD_THREADS * k;
      if (h >= H) break;
      const float corr = corr_s[h];
#pragma unroll
      for (int i = 0; i < Gm::CPT; ++i) acc[k][i] *= corr;
    }
    for (int j = 0; j < ps; ++j) {
      float v[Gm::CPT];
#pragma unroll
      for (int i = 0; i < Gm::CPT; ++i)
        v[i] = ckv[j * Gm::CKV_STRIDE + ct + Gm::COLS * i];
#pragma unroll
      for (int k = 0; k < Gm::HPT; ++k) {
        const int h = ht + Gm::HEAD_THREADS * k;
        if (h >= H) break;
        const float pr = sc[h * ps + j];
#pragma unroll
        for (int i = 0; i < Gm::CPT; ++i) acc[k][i] += pr * v[i];
      }
    }
  }
  __syncthreads();                         // l_s final for every thread

#pragma unroll
  for (int k = 0; k < Gm::HPT; ++k) {
    const int h = ht + Gm::HEAD_THREADS * k;
    if (h >= H) break;
    const float inv = 1.f / fmaxf(l_s[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < Gm::CPT; ++i)
      out[h * R + ct + Gm::COLS * i] = from_f32<T>(acc[k][i] * inv);
  }
}

// Raise the block's dynamic shared-memory limit when the tile needs more
// than the default 48 KB; returns the cudaError_t (0 = fine).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace repro_torch
