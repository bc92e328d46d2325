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
// peak, 0.03 ms at 3.35 TB/s.  This first kernel computes both products
// with scalar fp32 FMAs (67 TFLOP/s peak off the tensor cores), so it sits
// at least ~15x above the bound, and more where shared-memory loads limit
// the FMA rate.  What the design does: the TPU grid's sequential kv axis
// becomes a loop inside the block; one block per (query row bh, 64-query
// tile) holds the Q tile and each 64-key K/V tile in shared memory as fp32
// (16-byte global loads), and a 4 x 8 (scores) / 4 x hd/8 (output) register
// tile per thread reuses every shared-memory load 4-16 times.  The key loop
// starts at the tile's window edge and stops at its causal horizon, so tiles
// above the diagonal or outside the window are never loaded, and the
// heaviest (latest) query tiles are scheduled first.  Tensor-core tiles
// (mma.sync / wgmma) and TMA are later work.
//
// Head dims 64, 128 and 256 (recurrentgemma's local attention).  At hd 256
// the fp32 tiles take (64 + 64) * 257 + 64 * 256 + 64 * 65 floats = 213,760
// bytes of shared memory, under the 232,448 a block may opt in to (the
// launch sets cudaFuncAttributeMaxDynamicSharedMemorySize above 48 KB), and
// a thread holds a 4 x 32 output tile.
#include "paged_common.cuh"

namespace repro_torch {

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

template <typename T>
int fa_launch_hd(int hd, const void* q, const void* k, const void* v,
                 void* out, void* lse, int BH, int G, int Sq, int Sk,
                 int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return fa_launch<T, 64>(q, k, v, out, lse, BH, G, Sq, Sk, causal,
                              window, stream);
    case 128:
      return fa_launch<T, 128>(q, k, v, out, lse, BH, G, Sq, Sk, causal,
                               window, stream);
    case 256:
      return fa_launch<T, 256>(q, k, v, out, lse, BH, G, Sq, Sk, causal,
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
  const int G = BH / BKV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return fa_launch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, BH, G, Sq, Sk,
                                       causal, window, s);
  if (dtype == DTYPE_F32)
    return fa_launch_hd<float>(hd, q, k, v, out, lse, BH, G, Sq, Sk, causal,
                               window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
