// Flash-attention forward for Hopper (sm_90a): causal / sliding-window
// self-attention with GQA, fp32 online softmax, and the row logsumexp.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// `flash_attention_bhsd` / `_flash_kernel` (K3).  q [BH, Sq, hd], k/v
// [BKV, Sk, hd] (GQA: query row bh reads kv row bh / G), scale hd^-0.5.  Key
// k_pos is valid for query q_pos when k_pos < Sk, (causal) k_pos <= q_pos and
// (window > 0) k_pos > q_pos - window; positions count from 0 on both axes.
// Masked scores take the finite NEG_INF, the softmax state (m, l, acc) is
// fp32, and the output is acc / max(l, 1e-30) in q's dtype.  Beside the
// output the kernel writes L = m + log(max(l, 1e-30)) as fp32 [BH, Sq]: the
// TPU kernel keeps m and l in VMEM scratch only, but the port's backward
// (models/flash_vjp.py `_bwd`) recomputes the probabilities from L.
//
// What bounds it on an H100: operations.  At the training shape (B = 2,
// S = 2048, 40 query / 8 kv heads, hd = 128, causal) the work is ~86 GFLOP
// against ~0.1 GB of bytes: 0.087 ms at the 989 TFLOP/s bf16 tensor-core
// peak, 0.03 ms at 3.35 TB/s.  So the products belong on the tensor cores.
//
// The bf16 design (flash_fwd_kernel_wgmma): one warpgroup (4 warps) per
// (query row bh, 64-query tile), the wgmma's M; the TPU grid's sequential
// kv axis becomes a loop inside the block over key tiles of 64 keys (32 at
// hd 256) that starts at the tile's window edge and stops at its causal
// horizon, so tiles above the diagonal or outside the window are never
// loaded, and only the diagonal, window-edge and ragged tiles are masked.
// Q and each K / V tile go bf16 into 128-byte-swizzled shared memory by
// cp.async, K / V double-buffered; the next tile's copies are issued while
// the tensor cores take this tile's Q K^T.  Q K^T is wgmma with both
// operands in shared memory; P V takes P from registers as two bf16
// operands, hi + lo, which hold P to ~2^-18 (bf16 P alone moves outputs
// near 2 by a bf16 ulp against the plain version) and V transposed from
// shared memory (attn_tiles.cuh).  The heaviest (latest) query tiles are
// scheduled first.  Two blocks share an SM (Q 16 KB + two stages of K / V,
// 64 KB, at hd 128), so one block's softmax runs under the other's
// products; a three-stage, software-pipelined variant (the next tile's
// Q K^T under this tile's softmax) measured slower.
//
// fp32 (flash_fwd_kernel<float, HD>) keeps the scalar body of the first
// port — Q, K and V tiles in shared memory as fp32, 4 x 8 register tiles of
// scalar FMAs — chosen by dtype alone: it feeds the flash autograd check
// (gradients within 1e-4) and recurrentgemma's fp32 arm, and TF32 tensor
// cores (10-bit mantissa) would spend those margins.  At hd 256 its fp32
// tiles take (64 + 64) * 257 + 64 * 256 + 64 * 65 floats = 213,760 bytes of
// shared memory, under the 232,448 a block may opt in to.
#include "attn_tiles.cuh"

namespace repro_torch {

// ---------------------------------------------------------------------------
// fp32 scalar kernel (the first port's body, unchanged)
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;            // queries per block
constexpr int FA_BK = 64;            // keys per tile
constexpr int FA_TX = 8;             // threads sharing one group of rows
constexpr int FA_RM = 4;             // rows per thread
constexpr int FA_THREADS = (FA_BQ / FA_RM) * FA_TX;   // 128
constexpr int FA_SC = FA_BK / FA_TX; // score columns per thread
constexpr int FA_PS = FA_BK + 1;     // padded row stride of the P tile

// Copy rows [row0, row0 + 64) of a [n_rows, HD] matrix into shared memory
// as fp32 with row stride `stride`; rows past n_rows are zero.  16-byte
// loads, all threads of the block take part.
template <typename T, int HD>
__device__ __forceinline__ void fa_load_rows(float* dst, int stride,
                                             const T* src, int row0,
                                             int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < FA_BK * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    float* d = dst + r * stride + c;
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * HD + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = to_f32(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = 0.f;
    }
  }
}

// max / sum over the 8 lanes (one row group) that share a query row
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < FA_TX; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < FA_TX; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int G, int causal,
                 int window, float scale) {
  constexpr int QS = HD + 1;         // padded row stride of the Q / K tiles
  constexpr int OC = HD / FA_TX;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][QS]
  float* ks = qs + FA_BQ * QS;       // [BK][QS]
  float* vs = ks + FA_BK * QS;       // [BK][HD]
  float* ps = vs + FA_BK * HD;       // [BQ][PS]

  const int nq = (Sq + FA_BQ - 1) / FA_BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * FA_BQ;
  const int bh = blockIdx.y;
  const int kvh = bh / G;
  const int tx = threadIdx.x % FA_TX;
  const int r0 = (threadIdx.x / FA_TX) * FA_RM;   // this thread's rows

  fa_load_rows<T, HD>(qs, QS, q + static_cast<int64_t>(bh) * Sq * HD, q0,
                      Sq);
  const T* kb = k + static_cast<int64_t>(kvh) * Sk * HD;
  const T* vb = v + static_cast<int64_t>(kvh) * Sk * HD;

  float m[FA_RM], l[FA_RM], acc[FA_RM][OC];
#pragma unroll
  for (int i = 0; i < FA_RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold a valid key for some query of this tile
  const int k_end = causal ? min(Sk, q0 + FA_BQ) : Sk;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int kt_hi = (k_end + FA_BK - 1) / FA_BK;

  for (int kt = k_begin / FA_BK; kt < kt_hi; ++kt) {
    const int kstart = kt * FA_BK;
    __syncthreads();                 // previous K / V / P tiles consumed
    fa_load_rows<T, HD>(ks, QS, kb, kstart, Sk);
    fa_load_rows<T, HD>(vs, HD, vb, kstart, Sk);
    __syncthreads();

    float s[FA_RM][FA_SC];
#pragma unroll
    for (int i = 0; i < FA_RM; ++i)
#pragma unroll
      for (int j = 0; j < FA_SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[FA_RM];
#pragma unroll
      for (int i = 0; i < FA_RM; ++i) qv[i] = qs[(r0 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < FA_SC; ++j) {
        const float kv = ks[(tx + FA_TX * j) * QS + d];
#pragma unroll
        for (int i = 0; i < FA_RM; ++i) s[i][j] += qv[i] * kv;
      }
    }

#pragma unroll
    for (int i = 0; i < FA_RM; ++i) {
      const int q_pos = q0 + r0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < FA_SC; ++j) {
        const int k_pos = kstart + tx + FA_TX * j;
        const bool ok = k_pos < Sk && (!causal || k_pos <= q_pos) &&
                        (!window || k_pos > q_pos - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < FA_SC; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(r0 + i) * FA_PS + tx + FA_TX * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();                    // a row's P is written by its 8 lanes

#pragma unroll 4
    for (int t = 0; t < FA_BK; ++t) {
      float pv[FA_RM];
#pragma unroll
      for (int i = 0; i < FA_RM; ++i) pv[i] = ps[(r0 + i) * FA_PS + t];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = vs[t * HD + tx + FA_TX * c];
#pragma unroll
        for (int i = 0; i < FA_RM; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < FA_RM; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<int64_t>(bh) * Sq + row) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[tx + FA_TX * c] = from_f32<T>(acc[i][c] / lc);
    if (tx == 0) lse[static_cast<int64_t>(bh) * Sq + row] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
int fa_launch(const void* q, const void* k, const void* v, void* out,
              void* lse, int BH, int G, int Sq, int Sk, int causal,
              int window, cudaStream_t stream) {
  constexpr int QS = HD + 1;
  const size_t smem = (static_cast<size_t>(FA_BQ + FA_BK) * QS +
                       static_cast<size_t>(FA_BK) * HD +
                       static_cast<size_t>(FA_BQ) * FA_PS) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, BH);
  kernel<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Sk, G, causal, window,
      1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int FW_BQ = 64;            // queries per block: one warpgroup
constexpr int FW_THREADS = 128;

// One warpgroup per (query row bh, 64-query tile), BK keys a tile.  Shared
// memory, all 128-byte swizzled: Q [HD / 64][64][64], then two stages of
// K and V [HD / 64][BK][64] each.
template <int HD, int BK>
__global__ void __launch_bounds__(FW_THREADS)
flash_fwd_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int G,
                       int causal, int window, float scale_log2) {
  constexpr int NT = BK / 8;         // 8-key score tiles
  constexpr int NO = HD / 8;         // 8-column output tiles
  constexpr int QE = FW_BQ * HD;     // elements of the Q tile
  constexpr int KE = BK * HD;        // elements of one K or V tile
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  __nv_bfloat16* kv = q_tile + QE;   // [stage][K | V]

  const int nq = (Sq + FW_BQ - 1) / FW_BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * FW_BQ;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(bh) * Sq * HD;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(bh / G) * Sk * HD;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(bh / G) * Sk * HD;

  // key tiles that hold a valid key for some query of this tile
  const int k_end = causal ? min(Sk, q0 + FW_BQ) : Sk;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;
  const int q_last = q0 + FW_BQ - 1;
  // this thread's two rows: gid and gid + 8 of its warp's 16
  const int ra = q0 + warp * 16 + lane / 4;

  auto issue_tile = [&](int t, int st) {
    const int k0 = t * BK;
    cp_async_rows_sw128<HD, FW_THREADS>(
        kv + 2 * st * KE, BK, kb, [&](int r) -> const __nv_bfloat16* {
          return k0 + r < Sk ? kb + static_cast<int64_t>(k0 + r) * HD
                             : nullptr;
        });
    cp_async_rows_sw128<HD, FW_THREADS>(
        kv + (2 * st + 1) * KE, BK, vb, [&](int r) -> const __nv_bfloat16* {
          return k0 + r < Sk ? vb + static_cast<int64_t>(k0 + r) * HD
                             : nullptr;
        });
  };

  float o[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // prologue: Q (rows past Sq zero) and the first key tile
  cp_async_rows_sw128<HD, FW_THREADS>(
      q_tile, FW_BQ, qb, [&](int r) -> const __nv_bfloat16* {
        return q0 + r < Sq ? qb + static_cast<int64_t>(q0 + r) * HD
                           : nullptr;
      });
  if (t_begin < t_end) issue_tile(t_begin, 0);
  cp_async_commit();

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();                 // tile t landed; t - 1 consumed
    const __nv_bfloat16* kd = kv + 2 * st * KE;
    const __nv_bfloat16* vd = kd + KE;

    // S = Q K^T: HD / 16 k-steps, 32 bytes each into a 64-column block
    float s[NT][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(s,
               sw128_desc(q_tile + (ks >> 2) * FW_BQ * 64 + (ks & 3) * 16, 0,
                          1024),
               sw128_desc(kd + (ks >> 2) * BK * 64 + (ks & 3) * 16, 0, 1024),
               ks > 0);
    wgmma_commit();
    // while the tensor cores take it: the next tile's copies
    if (t + 1 < t_end) issue_tile(t + 1, st ^ 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int k0 = t * BK;
    const bool masked = (causal && k0 + BK - 1 > q0) ||
                        (window && k0 <= q_last - window) || k0 + BK > Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int kp = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
          const int qp = ra + 8 * (e >> 1);
          const bool ok = kp < Sk && (!causal || kp <= qp) &&
                          (!window || kp > qp - window);
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }
    float corr[2];
    softmax_p<NT>(s, m, l, corr);
    rescale_o<NO>(o, corr);

    // O += P V: P as hi + lo bf16 operands from registers, V transposed
    uint32_t hi[NT / 2][4], lo[NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) split_p<NT>(hi[kk], lo[kk], s, kk);
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint64_t dv = sw128_desc(vd + kk * 16 * 64, BK * 128, 1024);
      wgmma_rt(o, hi[kk], dv, 1);
      wgmma_rt(o, lo[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
  }

  const int col0 = (lane % 4) * 2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = ra + 8 * hr;
    const float lc = fmaxf(quad_sum(l[hr]), 1e-30f);
    if (row >= Sq) continue;
    const float inv = 1.f / lc;
    __nv_bfloat16* dst = out + (static_cast<int64_t>(bh) * Sq + row) * HD + col0;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<uint32_t*>(dst + c * 8) =
          pack_bf16(o[c][2 * hr] * inv, o[c][2 * hr + 1] * inv);
    if (lane % 4 == 0)                // m in log2 units
      lse[static_cast<int64_t>(bh) * Sq + row] =
          (m[hr] == NEG_INF ? NEG_INF : m[hr] * LN2) + logf(lc);
  }
}

template <int HD, int BK>
int fa_launch_wgmma(const void* q, const void* k, const void* v, void* out,
                    void* lse, int BH, int G, int Sq, int Sk, int causal,
                    int window, cudaStream_t stream) {
  // Q, two stages of K and V, and up to 1 KB to align the base
  const size_t smem = (static_cast<size_t>(FW_BQ) + 4 * BK) * HD *
                          sizeof(__nv_bfloat16) + 1024;
  auto kernel = flash_fwd_kernel_wgmma<HD, BK>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  using bf16 = __nv_bfloat16;
  dim3 grid((Sq + FW_BQ - 1) / FW_BQ, BH);
  kernel<<<grid, FW_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Sk, G, causal, window,
      LOG2E / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (dtype, head dim): bf16 to the tensor-core kernel, fp32 to
// the scalar body
int fa_launch_hd(int dtype, int hd, const void* q, const void* k,
                 const void* v, void* out, void* lse, int BH, int G, int Sq,
                 int Sk, int causal, int window, cudaStream_t stream) {
  if (dtype == DTYPE_BF16) {
    switch (hd) {
      case 64:
        return fa_launch_wgmma<64, 64>(q, k, v, out, lse, BH, G, Sq, Sk,
                                       causal, window, stream);
      case 128:
        return fa_launch_wgmma<128, 64>(q, k, v, out, lse, BH, G, Sq, Sk,
                                        causal, window, stream);
      case 256:
        return fa_launch_wgmma<256, 32>(q, k, v, out, lse, BH, G, Sq, Sk,
                                        causal, window, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != DTYPE_F32) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return fa_launch<float, 64>(q, k, v, out, lse, BH, G, Sq, Sk, causal,
                                  window, stream);
    case 128:
      return fa_launch<float, 128>(q, k, v, out, lse, BH, G, Sq, Sk, causal,
                                   window, stream);
    case 256:
      return fa_launch<float, 256>(q, k, v, out, lse, BH, G, Sq, Sk, causal,
                                   window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

// q [BH, Sq, hd]; k/v [BKV, Sk, hd] with BH = G * BKV; out [BH, Sq, hd] in
// the inputs' dtype; lse [BH, Sq] fp32.  causal / window as in the header
// note.  Returns the cudaError_t of the launch (0 = queued).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int BH, int BKV, int Sq, int Sk,
                                      int hd, int causal, int window,
                                      int dtype, void* stream) {
  using namespace repro_torch;
  if (BKV < 1 || BH % BKV != 0 || Sq < 1 || Sk < 1 || window < 0 ||
      BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return fa_launch_hd(dtype, hd, q, k, v, out, lse, BH, BH / BKV, Sq, Sk,
                      causal, window, static_cast<cudaStream_t>(stream));
}
