// The MoE sorted route's routed experts as one grouped GEMM (K11) for
// Hopper (sm_90a): for every pick (token, choice) of a local expert e,
//   h   = bf16(bf16(silu(bf16(x W_gate[e]))) * bf16(x W_up[e]))
//   row = fp32(bf16(h W_down[e])) * fp32(gate)
// and every token's rows summed from 0.0 in fp32 in ascending expert
// order, the rounding points of models/moe.py's _expert and the loop this
// replaces (in fp32 every rounding is the identity).
//
// Replaces no Pallas kernel: the JAX package computes per-token MoE as a
// dense einsum dispatch over all experts (src/repro/models/moe.py,
// moe_apply(per_token=True)).  The port's sorted route ran each expert as
// its own chain of eager products after reading the group sizes back to
// the host: a sync and ~a dozen launches per expert a layer (64 experts on
// deepseek-v2-lite: ~17k of a 512-token chunk's ~20.5k launches).
//
// What bounds it on an H100: the expert weights' bytes.  A 512-token chunk
// at deepseek-v2-lite's top-6 touches all 64 experts: 64 x 3 x 2048 x 1408
// bf16 = 1.107 GB a layer, 0.33 ms at 3.35 TB/s, against 53.2 GFLOP (0.054
// ms at 989 TFLOP/s); ~48 rows an expert are far below the ~295 FLOP a
// byte where the tensor cores would bind.
//
// The design, three launches over a tile table built on the device
// (kernels/moe_grouped/ref.py group_picks: the picks sorted by expert, each
// local expert's rows cut into tiles of BM sorted rows, the table's length
// fixed by the shapes; a block whose slot is past the live tiles exits):
//  * gate/up: a block owns (tile, BN columns of F).  It gathers its <= BM
//    token rows of x by index and streams W_gate[e] and W_up[e]'s columns,
//    both through a 4-stage cp.async ring of BK = 32-deep slices (swizzled
//    so that ldmatrix reads are conflict-free), and accumulates both
//    products in fp32 with mma.sync m16n8k16 (8 warps, 32 x 32 outputs of
//    each product a warp).  The epilogue rounds as above and writes h in
//    sorted order.  No split-K: at deepseek's chunk a layer is 11 x ~64
//    live blocks of 1 MB of weights each.
//  * down: the same body over the same table, A the contiguous sorted rows
//    of h and B W_down[e]; the epilogue rounds to bf16, multiplies by the
//    gate in fp32 and writes fp32 rows in sorted order.
//  * combine: a block a token sorts its K picks by expert and sums their
//    rows from 0.0 in fp32 — the order of the loop's index_add_ calls, one
//    an expert, ascending; no atomics, so the sum is the same every run.
// Tiles are BM = 64 rows (ref.TILE_ROWS) by BN = 128 columns, 8 warps of
// 32 x 32: 128-row tiles were no faster at any shape measured on the H100,
// mixtral-8x22b's 128 rows an expert included, and slower at deepseek's
// (PERF.md §6, K11).  fp32 takes a plain scalar body (64-wide column
// tiles, a thread 4 columns of 4 rows) over the same table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tiles.cuh"

namespace repro_torch {

constexpr int MOE_THREADS = 256;   // 8 warps
constexpr int MOE_BM = 64;         // rows a tile (ref.TILE_ROWS)
constexpr int MOE_BN = 128;        // columns a block (bf16)
constexpr int MOE_BK = 32;         // the k depth of a stage (bf16)
constexpr int MOE_STAGES = 4;      // cp.async ring
constexpr int MOE_MAX_K = 16;      // choices a token (combine)

// the gate activation of every MoE configuration (swiglu), as PyTorch's
// CUDA silu computes it: in fp32, its opmath for bf16
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A stage's A slice: BM rows of 32 bf16 (64 bytes, 4 chunks of 16); chunk
// c of row r sits at c ^ ((r / 2) % 4), so the 8 rows an ldmatrix reads
// fall in 8 distinct bank groups.
__device__ __forceinline__ int swz_a(int r, int c) {
  return r * MOE_BK + ((c ^ ((r >> 1) & 3)) << 3);
}
// A stage's B slice: 32 rows (k) of BN bf16; chunk c of row k at c ^ (k % 8)
__device__ __forceinline__ int swz_b(int k, int c) {
  return k * MOE_BN + ((c ^ (k & 7)) << 3);
}

// The bf16 body.  GU: A = x gathered by tok, B = W_gate and W_up, out = h
// (bf16 [N*K, Nd]); else A = h's sorted rows, B = W_down, out = fp32 rows
// [N*K, Nd] weighted by gate.  Kd: the product's depth, Nd: its width.
template <bool GU>
__global__ void __launch_bounds__(MOE_THREADS)
    moe_gemm_bf16(const __nv_bfloat16* __restrict__ a,
                  const int64_t* __restrict__ tok,
                  const __nv_bfloat16* __restrict__ b0,
                  const __nv_bfloat16* __restrict__ b1,
                  const int64_t* __restrict__ tiles,
                  const __nv_bfloat16* __restrict__ gate, void* out, int Kd,
                  int Nd) {
  constexpr int BM = MOE_BM, BN = MOE_BN, NB = GU ? 2 : 1;
  constexpr int WN = BN / 32;                 // warps across the columns
  constexpr int A_ELEMS = BM * MOE_BK, B_ELEMS = MOE_BK * BN;
  constexpr int STAGE = A_ELEMS + NB * B_ELEMS;
  static_assert((BM / 32) * WN == MOE_THREADS / 32, "8 warps of 32 x 32");
  extern __shared__ __align__(128) unsigned char moe_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(moe_smem);
  __shared__ long long a_row[BM];             // element offset of A's rows

  const int64_t* tile = tiles + 3 * blockIdx.y;
  const int e = static_cast<int>(tile[0]), r0 = static_cast<int>(tile[1]);
  const int rows = static_cast<int>(tile[2] - tile[1]);
  const int n0 = blockIdx.x * BN;
  if (rows <= 0 || n0 >= Nd) return;          // an empty slot of the table
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = tid; r < BM; r += MOE_THREADS)
    a_row[r] = r < rows
                   ? (GU ? tok[r0 + r] : r0 + r) * static_cast<long long>(Kd)
                   : -1;
  __syncthreads();
  const size_t wofs = static_cast<size_t>(e) * Kd * Nd;
  const __nv_bfloat16* bs[2] = {b0 + wofs, GU ? b1 + wofs : b0 + wofs};
  const int ktiles = (Kd + MOE_BK - 1) / MOE_BK;

  auto load = [&](int slot, int kt) {
    const int k0 = kt * MOE_BK;
    __nv_bfloat16* sa = sm + slot * STAGE;
    for (int i = tid; i < BM * 4; i += MOE_THREADS) {
      const int r = i >> 2, c = i & 3, k = k0 + c * 8;
      const bool ok = a_row[r] >= 0 && k < Kd;
      cp_async16(sa + swz_a(r, c), ok ? a + a_row[r] + k : a, ok);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      __nv_bfloat16* sb = sa + A_ELEMS + m * B_ELEMS;
      for (int i = tid; i < MOE_BK * (BN / 8); i += MOE_THREADS) {
        const int k = i / (BN / 8), c = i % (BN / 8);
        const int kk = k0 + k, n = n0 + c * 8;
        const bool ok = kk < Kd && n < Nd;
        cp_async16(sb + swz_b(k, c),
                   ok ? bs[m] + static_cast<size_t>(kk) * Nd + n : bs[m], ok);
      }
    }
  };

  float acc[NB][2][4][4];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][j][q] = 0.0f;

  const int wm = warp / WN, wn = warp % WN;
#pragma unroll
  for (int s = 0; s < MOE_STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<MOE_STAGES - 2>();
    __syncthreads();              // slice kt landed; slot kt - 1 is free
    const int nk = kt + MOE_STAGES - 1;
    if (nk < ktiles) load(nk % MOE_STAGES, nk);
    cp_async_commit();
    const __nv_bfloat16* sa = sm + (kt % MOE_STAGES) * STAGE;
#pragma unroll
    for (int ks = 0; ks < MOE_BK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], sa + swz_a(wm * 32 + i * 16 + (lane & 15),
                                      (ks >> 3) + (lane >> 4)));
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        const __nv_bfloat16* sb = sa + A_ELEMS + m * B_ELEMS;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, sb + swz_b(ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                             ((wn * 32 + jp * 16) >> 3) + (lane >> 4)));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[m][i][2 * jp], af[i], bf[0], bf[1]);
            mma_bf16(acc[m][i][2 * jp + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: a thread holds rows gid and gid + 8 of each 16-row fragment,
  // columns 2 tig and 2 tig + 1 of each 8-column one
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + i * 16 + gid + half * 8;
      if (r >= rows) continue;
      const size_t orow = static_cast<size_t>(r0 + r) * Nd;
      const float g = GU ? 0.0f : __bfloat162float(gate[r0 + r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * tig;
        if (n >= Nd) continue;
        const float v0 = acc[0][i][j][2 * half], v1 = acc[0][i][j][2 * half + 1];
        if constexpr (GU) {
          const float h0 = bf16_round(silu(bf16_round(v0))) *
                           bf16_round(acc[1][i][j][2 * half]);
          const float h1 = bf16_round(silu(bf16_round(v1))) *
                           bf16_round(acc[1][i][j][2 * half + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + orow + n) =
              __floats2bfloat162_rn(h0, h1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + orow + n) =
              make_float2(bf16_round(v0) * g, bf16_round(v1) * g);
        }
      }
    }
}

// The fp32 body: the same table and roles, scalar FMA over 16-deep slices
// staged in shared memory; a block owns (tile, 64 columns), a thread 4
// columns (tx + 16 j) of BM / 16 rows (ty + 16 i).
template <bool GU>
__global__ void __launch_bounds__(MOE_THREADS)
    moe_gemm_f32(const float* __restrict__ a,
                 const int64_t* __restrict__ tok,
                 const float* __restrict__ b0, const float* __restrict__ b1,
                 const int64_t* __restrict__ tiles,
                 const float* __restrict__ gate, float* __restrict__ out,
                 int Kd, int Nd) {
  constexpr int BM = MOE_BM, NB = GU ? 2 : 1, BN = 64, BK = 16;
  constexpr int RI = BM / 16;
  __shared__ float sa[BK][BM + 1];
  __shared__ float sb[NB][BK][BN];
  __shared__ long long a_row[BM];
  const int64_t* tile = tiles + 3 * blockIdx.y;
  const int e = static_cast<int>(tile[0]), r0 = static_cast<int>(tile[1]);
  const int rows = static_cast<int>(tile[2] - tile[1]);
  const int n0 = blockIdx.x * BN;
  if (rows <= 0 || n0 >= Nd) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int r = tid; r < BM; r += MOE_THREADS)
    a_row[r] = r < rows
                   ? (GU ? tok[r0 + r] : r0 + r) * static_cast<long long>(Kd)
                   : -1;
  const size_t wofs = static_cast<size_t>(e) * Kd * Nd;
  const float* bs[2] = {b0 + wofs, GU ? b1 + wofs : b0 + wofs};
  float acc[NB][RI][4];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.0f;
  for (int k0 = 0; k0 < Kd; k0 += BK) {
    __syncthreads();              // a_row written; the last slice consumed
    for (int i = tid; i < BM * BK; i += MOE_THREADS) {
      const int r = i / BK, k = i % BK;
      sa[k][r] = a_row[r] >= 0 && k0 + k < Kd ? a[a_row[r] + k0 + k] : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < NB; ++m)
      for (int i = tid; i < BK * BN; i += MOE_THREADS) {
        const int k = i / BN, c = i % BN;
        sb[m][k][c] = k0 + k < Kd && n0 + c < Nd
                          ? bs[m][static_cast<size_t>(k0 + k) * Nd + n0 + c]
                          : 0.0f;
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k)
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float av = sa[k][ty + 16 * i];
#pragma unroll
        for (int m = 0; m < NB; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[m][i][j] = fmaf(av, sb[m][k][tx + 16 * j], acc[m][i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const size_t orow = static_cast<size_t>(r0 + r) * Nd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Nd) continue;
      if constexpr (GU)
        out[orow + n] = silu(acc[0][i][j]) * acc[1][i][j];
      else
        out[orow + n] = acc[0][i][j] * gate[r0 + r];
    }
  }
}

// A block a token: its K picks in ascending expert order (insertion sort
// of at most MOE_MAX_K), the local ones' rows summed from 0.0 in fp32.
__global__ void __launch_bounds__(MOE_THREADS)
    moe_combine(const float* __restrict__ rows,
                const int64_t* __restrict__ pick_e,
                const int64_t* __restrict__ inv, float* __restrict__ y, int K,
                int D, int first, int n_local) {
  const int t = blockIdx.x;
  int pe[MOE_MAX_K], pos[MOE_MAX_K];
  int n = 0;
  for (int k = 0; k < K; ++k) {
    const int ek = static_cast<int>(pick_e[t * K + k]);
    if (ek < first || ek >= first + n_local) continue;   // not this rank's
    int j = n++;
    for (; j > 0 && pe[j - 1] > ek; --j) {
      pe[j] = pe[j - 1];
      pos[j] = pos[j - 1];
    }
    pe[j] = ek;
    pos[j] = static_cast<int>(inv[t * K + k]);
  }
  float* yt = y + static_cast<size_t>(t) * D;
  if ((D & 3) == 0) {
    for (int d = threadIdx.x * 4; d < D; d += MOE_THREADS * 4) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < n; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            rows + static_cast<size_t>(pos[j]) * D + d);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<float4*>(yt + d) = s;
    }
  } else {
    for (int d = threadIdx.x; d < D; d += MOE_THREADS) {
      float s = 0.0f;
      for (int j = 0; j < n; ++j)
        s += rows[static_cast<size_t>(pos[j]) * D + d];
      yt[d] = s;
    }
  }
}

// one product of the route in the given dtype
template <bool GU>
cudaError_t launch_gemm(int dtype, const void* a, const int64_t* tok,
                        const void* b0, const void* b1, const int64_t* tiles,
                        const void* gate, void* out, int n_tiles, int Kd,
                        int Nd, cudaStream_t s) {
  if (dtype == DTYPE_F32) {
    moe_gemm_f32<GU><<<dim3((Nd + 63) / 64, n_tiles), MOE_THREADS, 0, s>>>(
        static_cast<const float*>(a), tok, static_cast<const float*>(b0),
        static_cast<const float*>(b1), tiles,
        static_cast<const float*>(gate), static_cast<float*>(out), Kd, Nd);
    return cudaGetLastError();
  }
  constexpr int smem =        // bytes: the ring of A and B slices
      MOE_STAGES * (MOE_BM * MOE_BK + (GU ? 2 : 1) * MOE_BK * MOE_BN) * 2;
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_bf16<GU>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  moe_gemm_bf16<GU>
      <<<dim3((Nd + MOE_BN - 1) / MOE_BN, n_tiles), MOE_THREADS, smem, s>>>(
          static_cast<const __nv_bfloat16*>(a), tok,
          static_cast<const __nv_bfloat16*>(b0),
          static_cast<const __nv_bfloat16*>(b1), tiles,
          static_cast<const __nv_bfloat16*>(gate), out, Kd, Nd);
  return cudaGetLastError();
}

}  // namespace repro_torch

// x [N, D]; w_gate, w_up [n_local, D, F]; w_down [n_local, F, D] (dtype);
// tok, gate [N*K] (int64, dtype): each sorted row's token and gate; tiles
// [n_tiles, 3] int64; pick_e, inv [N*K] int64: each pick's expert and
// sorted row; scratch h [N*K, F] (dtype) and rows [N*K, D] fp32; y [N, D]
// fp32.  Returns the first refused launch's cudaError_t, else 0.
extern "C" int moe_grouped_launch(const void* x, const void* w_gate,
                                  const void* w_up, const void* w_down,
                                  const void* tok, const void* gate,
                                  const void* tiles, const void* pick_e,
                                  const void* inv, void* h, void* rows,
                                  void* y, int N, int K, int D, int F,
                                  int n_tiles, int first, int n_local,
                                  int dtype, void* stream) {
  using namespace repro_torch;
  if (N < 1 || K < 1 || K > MOE_MAX_K || D < 8 || F < 8 || D % 8 ||
      F % 8 || n_tiles < 1 || n_tiles > 65535 ||
      (dtype != DTYPE_BF16 && dtype != DTYPE_F32) || N > 2147483647 / K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* tk = static_cast<const int64_t*>(tok);
  const int64_t* tl = static_cast<const int64_t*>(tiles);
  cudaError_t err = launch_gemm<true>(dtype, x, tk, w_gate, w_up, tl,
                                      nullptr, h, n_tiles, D, F, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<false>(dtype, h, tk, w_down, nullptr, tl, gate, rows,
                           n_tiles, F, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_combine<<<N, MOE_THREADS, 0, s>>>(
      static_cast<const float*>(rows), static_cast<const int64_t*>(pick_e),
      static_cast<const int64_t*>(inv), static_cast<float*>(y), K, D, first,
      n_local);
  return static_cast<int>(cudaGetLastError());
}
