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
// Queries that are bucket padding (i >= n_valid) write zeros and read no
// page for themselves — the Pallas kernel skips all-padding query blocks
// the same way; callers never read those rows.
//
// What bounds it on an H100: at the serving shapes (S = 5 verify rows,
// S = 16..64 prefill buckets) bytes and, above all, latency — the latent
// rows up to the chunk's horizon, (start + n_valid) (R + rp) 2 bytes in
// bf16, are at most a few hundred KB, against 2 H (2R + rp) flop per
// (query, key) pair.  The first port ran one block a query (a 5-row verify
// on 5 of 132 SMs), each walking its pages in series through the scalar
// fp32 body of paged_mla_common.cuh, every block re-reading the shared
// prefix: 0.061 ms on the card for the verify (5, 37, 3), 1.14x SDPA.
//
// The bf16 design (paged_mla_prefill_kernel_mma), K6's (paged_mla.cu)
// with query rows in place of a slot's heads:
//  * A block owns MP_QG = 4 queries q0 .. q0 + 3: NQ = 4 H rows, row
//    n = (query - q0) H + head, contiguous in q_lat.  Its keys are [0, hi),
//    hi = start + i + 1 for i its last live query (i < n_valid): the
//    causal horizon, so no page past it is read.  A block of padding
//    queries has no keys and writes zeros.
//  * Split over key tiles in a cluster.  Grid (ceil(S / 4), splits): of
//    the block's T = ceil(hi / 32) key tiles, split z takes [z T / splits,
//    (z + 1) T / splits) (`mla_prefill_splits` in kernels/paged_attention/
//    kernel.py picks the count from the shapes and the chunk's host-side
//    bounds: no host sync).  The splits of a query block are one
//    thread-block cluster (at most 8, the portable size) and merge in the
//    same launch through distributed shared memory, as K6 merges.
//  * Rounds of MP_KEYS = 32 keys through a two-stage cp.async pipeline into
//    swizzled bf16 [ckv | krope] tiles (K6's: 16-byte chunk c of row r at
//    c ^ (r % 8)); Q (NQ rows, 72 KB at deepseek's width) and the first two
//    rounds in flight together.
//  * Scores on the tensor cores, keys as M and query rows as N: S^T = K
//    Q^T in KD / 16 k-steps of mma.sync m16n8k16, each of the 8 warps one
//    (16 keys, 16 rows) tile of the round's 32 x 64, into a [row][key]
//    score tile.  Tiles of padding queries' rows (a verify's last query
//    block) are skipped here and in P V.
//  * Online softmax once per row (a quad of threads a row, 8 keys each),
//    in fp32, log2 units, NEG_INF = -0.7 f32max; key pos is live for row n
//    of query i iff pos < k1 (the split's end, <= hi <= start + n_valid)
//    and pos <= start + i.  Masked keys are exactly 0 while a row's max is
//    NEG_INF (the exponent is then taken against 0).  P goes to shared
//    memory as hi + lo bf16 (P to ~2^-18: bf16 P alone moves outputs by a
//    bf16 ulp), with the rows' rescale factors.
//  * P V split by latent column: warp w owns columns [64 w, 64 w + 64):
//    O^T[64, NQ] += ckv^T P^T, ckv^T by ldmatrix.trans from the same tile,
//    P^T by ldmatrix from the P rows (80-byte rows: distinct banks); 128
//    fp32 registers a lane at deepseek's width.
//  * Epilogue: the block's (O, m, l) in shared memory over the stages;
//    unsplit it writes out / max(l, 1e-30), split every block of the
//    cluster merges 1 / splits of the [NQ][R] outputs from its peers'
//    shared memory as merge_partials_ref does (an empty split's
//    (NEG_INF, 0, 0) weighs 0; padding queries' rows are written 0 without
//    reading the peers).  The merge costs about one round, so a block's
//    key tiles are split only where that saves more (the count's rule).
//
// fp32 keeps the scalar body of the first port (paged_mla_common.cuh's
// mla_attend, one block a query, unsplit), chosen by dtype: it is what
// the deepseek fp32 arm runs, within 1e-5 of the plain version.
#include <cooperative_groups.h>

#include "attn_tiles.cuh"
#include "paged_mla_common.cuh"

namespace repro_torch {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// fp32: the scalar body, one block a query
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: mma.sync, split over key tiles
// ---------------------------------------------------------------------------

constexpr int MP_QG = 4;                    // queries a block
constexpr int MP_KEYS = 32;                 // keys a round (a key tile)
constexpr int MP_WARPS = 8;
constexpr int MP_THREADS = MP_WARPS * 32;
// the most splits a launch takes: the splits of a query block are one
// cluster, and 8 blocks is the portable cluster size
constexpr int MP_MAX_SPLITS = 8;

template <int H, int R, int RP>
struct MlaPrefillGeom {
  static constexpr int KD = (R + RP + 63) / 64 * 64;  // padded row, elements
  static constexpr int ROWB = KD * 2;                 // bytes of a row
  static constexpr int CH = KD / 8;                   // 16-byte chunks a row
  static constexpr int KSTEPS = KD / 16;              // even
  static constexpr int NQ = MP_QG * H;                // (query, head) rows
  static constexpr int NT = NQ / 8;                   // 8-row n-tiles
  static constexpr int NP = NQ / 16;                  // 16-row n-pairs
  static constexpr int KM = MP_KEYS / 16;             // 16-key m-tiles
  static constexpr int MT = R / 16;                   // 16-column tiles of O
  static constexpr int MTW = (MT + MP_WARPS - 1) / MP_WARPS;  // ... a warp
  static constexpr int STAGE = MP_KEYS * ROWB;
  static constexpr int QBYTES = NQ * ROWB;
  static constexpr int SS = MP_KEYS + 4;              // floats a score row
  static constexpr int PST = MP_KEYS + 8;             // bf16 a P row (80 B)
  static constexpr int OS = R + 4;                    // floats an output row
  static_assert(R % 16 == 0 && (R + RP) % 8 == 0, "16-byte rows");
  static_assert(NQ % 16 == 0 && NQ * 4 <= MP_THREADS,
                "whole n-pairs; a quad of threads a row in the softmax");
  static_assert(MP_KEYS == 32, "the softmax gives a thread 8 keys");
  static_assert(NQ * OS * 4 + (MP_MAX_SPLITS + 3) * NQ * 4 <=
                    2 * STAGE + QBYTES,
                "the epilogue and the merge fit the stages and Q");

  static size_t smem(int n_pages) {
    return 2 * static_cast<size_t>(STAGE) + QBYTES + NQ * SS * 4 +
           2 * NQ * PST * 2 + NQ * 4 + (n_pages + 1) * sizeof(int);
  }
};

template <int H, int R, int RP>
__global__ void __launch_bounds__(MP_THREADS, 1)
paged_mla_prefill_kernel_mma(const __nv_bfloat16* __restrict__ q_lat,
                             const __nv_bfloat16* __restrict__ q_rope,
                             const __nv_bfloat16* __restrict__ ckv_pages,
                             const __nv_bfloat16* __restrict__ krope_pages,
                             const int* __restrict__ page_row,
                             __nv_bfloat16* __restrict__ out, int S, int ps,
                             int start, int n_valid, float scale_log2) {
  using Gm = MlaPrefillGeom<H, R, RP>;
  constexpr int ROWB = Gm::ROWB, CH = Gm::CH, NQ = Gm::NQ, NT = Gm::NT;
  constexpr int SS = Gm::SS, PST = Gm::PST, MTW = Gm::MTW, OS = Gm::OS;
  // (not `smem`: mla_attend declares that name as float in this file)
  extern __shared__ __align__(128) unsigned char mp_smem[];
  unsigned char* stages = mp_smem;                      // [2][32 keys][KD]
  unsigned char* qs = mp_smem + 2 * Gm::STAGE;          // [NQ][KD]
  float* sc = reinterpret_cast<float*>(qs + Gm::QBYTES);      // [NQ][SS]
  __nv_bfloat16* phi = reinterpret_cast<__nv_bfloat16*>(sc + NQ * SS);
  __nv_bfloat16* plo = phi + NQ * PST;                  // [NQ][PST] each
  float* corr_s = reinterpret_cast<float*>(plo + NQ * PST);   // [NQ]
  int* tbl = reinterpret_cast<int*>(corr_s + NQ);       // the split's pages

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * MP_QG;
  const int splits = gridDim.y, z = blockIdx.y;

  // the block's live queries [q0, qv), its keys [0, hi) and this split's
  // key tiles [t0, t1), keys [k0, k1)
  const int qv = min(q0 + MP_QG, n_valid);
  const int hi = qv > q0 ? start + qv : 0;
  const int tiles = (hi + MP_KEYS - 1) / MP_KEYS;
  const int t0 = z * tiles / splits, t1 = (z + 1) * tiles / splits;
  const int k0 = t0 * MP_KEYS, k1 = min(t1 * MP_KEYS, hi);
  const int rounds = t1 - t0;
  const int p0 = k0 / ps;
  const bool ps_pow2 = (ps & (ps - 1)) == 0;
  const int ps_shift = __ffs(ps) - 1;

  if (rounds > 0)
    for (int i = tid; i < (k1 + ps - 1) / ps - p0; i += MP_THREADS)
      tbl[i] = page_row[p0 + i];
  __syncthreads();

  // Q rows [q_lat | q_rope | 0] of the live queries, the rest zero
  {
    const int64_t r0 = static_cast<int64_t>(q0) * H;
    for (int i = tid; i < NQ * CH; i += MP_THREADS) {
      const int n = i / CH, c = i % CH;
      const __nv_bfloat16* src = nullptr;
      if (q0 + n / H < qv) {
        if (c < R / 8)
          src = q_lat + (r0 + n) * R + 8 * c;
        else if (c < (R + RP) / 8)
          src = q_rope + (r0 + n) * RP + 8 * (c - R / 8);
      }
      cp_async16(qs + n * ROWB + ((c ^ (n & 7)) << 4), src ? src : q_lat,
                 src != nullptr);
    }
  }
  // round j's rows into stage j % 2: key kr + r, its 16-byte chunk c at
  // chunk c ^ (r % 8); rows past the split's keys and the row padding
  // zero-filled (never read from the pages)
  auto issue = [&](int j) {
    unsigned char* dst = stages + (j & 1) * Gm::STAGE;
    const int kr = k0 + j * MP_KEYS;
    for (int i = tid; i < MP_KEYS * CH; i += MP_THREADS) {
      const int r = i / CH, c = i % CH;
      const int pos = kr + r;
      const __nv_bfloat16* src = nullptr;
      if (pos < k1) {
        const int pi = ps_pow2 ? pos >> ps_shift : pos / ps;
        const int64_t key =
            static_cast<int64_t>(tbl[pi - p0]) * ps + (pos - pi * ps);
        if (c < R / 8)
          src = ckv_pages + key * R + 8 * c;
        else if (c < (R + RP) / 8)
          src = krope_pages + key * RP + 8 * (c - R / 8);
      }
      cp_async16(dst + r * ROWB + ((c ^ (r & 7)) << 4),
                 src ? src : ckv_pages, src != nullptr);
    }
  };
  if (rounds > 0) issue(0);
  cp_async_commit();
  if (rounds > 1) issue(1);
  cp_async_commit();

  // softmax state of row sn (a quad of threads a row, keys 8 sp.. of a
  // round); sn past NQ: the thread takes no row
  const int sn = tid >> 2, sp = tid & 3;
  const int sq = q0 + sn / H;                   // the row's query
  const int lim = sq < n_valid ? min(k1, start + sq + 1) : k0;
  float m = NEG_INF, l = 0.f;
  // O^T: columns 16 mt + gid (+ 8) of rows 8 nt + 2 tig (+ 1), mt = w MTW + i
  float acc[MTW][NT][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  for (int j = 0; j < rounds; ++j) {
    cp_async_wait<1>();                     // one group a round: j landed
    __syncthreads();
    const unsigned char* st = stages + (j & 1) * Gm::STAGE;
    const int kr = k0 + j * MP_KEYS;

    // S^T (16 keys x 16 rows a warp) = K Q^T; A = K rows by ldmatrix
    // (matrix m: keys + 8 (m & 1), chunk 2 ks + m / 2), B = Q^T (matrix
    // m: rows + 8 (m / 2), chunk 2 ks + (m & 1))
    for (int u = w; u < Gm::KM * Gm::NP; u += MP_WARPS) {
      const int km = u % Gm::KM, np = u / Gm::KM;
      // no live key, or rows of padding queries only: the softmax masks
      // whatever the tile holds
      if (kr + 16 * km >= k1 || q0 + 16 * np / H >= qv) continue;
      // two sums (even and odd k-steps) halve the chain of dependent mmas
      float s[2][2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          s[a][b][0] = s[a][b][1] = s[a][b][2] = s[a][b][3] = 0.f;
      const int ak = 16 * km + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int bn = 16 * np + (lane & 7) + ((lane >> 4) << 3);
      const unsigned char* arow = st + ak * ROWB;
      const unsigned char* brow = qs + bn * ROWB;
#pragma unroll 3
      for (int k2 = 0; k2 < Gm::KSTEPS; k2 += 2)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          uint32_t a[4], b[4];
          const int ac = 2 * (k2 + v) + (lane >> 4);
          const int bc = 2 * (k2 + v) + ((lane >> 3) & 1);
          ldmatrix_x4(a, arow + ((ac ^ (ak & 7)) << 4));
          ldmatrix_x4(b, brow + ((bc ^ (bn & 7)) << 4));
          mma_bf16(s[v][0], a, b[0], b[1]);
          mma_bf16(s[v][1], a, b[2], b[3]);
        }
      // scores in log2 units into the [row][key] tile
      const int key = 16 * km + gid;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float* r0 = sc + (16 * np + 8 * b + 2 * tig) * SS + key;
        r0[0] = (s[0][b][0] + s[1][b][0]) * scale_log2;
        r0[SS] = (s[0][b][1] + s[1][b][1]) * scale_log2;
        r0[8] = (s[0][b][2] + s[1][b][2]) * scale_log2;
        r0[SS + 8] = (s[0][b][3] + s[1][b][3]) * scale_log2;
      }
    }
    __syncthreads();                        // the round's scores

    // online softmax of row sn over keys kr + 8 sp .. + 7; P as hi + lo
    if (sn < NQ) {                          // whole warps (NQ % 8 == 0)
      const float* srow = sc + sn * SS + 8 * sp;
      const float4 x0 = *reinterpret_cast<const float4*>(srow);
      const float4 x1 = *reinterpret_cast<const float4*>(srow + 4);
      float p[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const int pos = kr + 8 * sp;
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = pos + e < lim ? p[e] : NEG_INF;
        mx = fmaxf(mx, p[e]);
      }
      mx = quad_max(mx);
      const float m_new = fmaxf(m, mx);
      const float base = m_new == NEG_INF ? 0.f : m_new;
      const float corr = ex2(m - base);
      m = m_new;
      float sum = 0.f;
      uint32_t h[4], lo[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float a = ex2(p[e] - base), b = ex2(p[e + 1] - base);
        sum += a + b;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(hv);
        h[e / 2] = *reinterpret_cast<const uint32_t*>(&hv);
        lo[e / 2] = pack_bf16(a - hf.x, b - hf.y);
      }
      l = l * corr + sum;
      *reinterpret_cast<uint4*>(phi + sn * PST + 8 * sp) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(plo + sn * PST + 8 * sp) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      if (sp == 0) corr_s[sn] = corr;
    }
    __syncthreads();                        // P and the factors

    // O^T *= corr by row; O^T += ckv^T P^T over the live key steps; A =
    // ckv^T by ldmatrix.trans (matrix m: keys + 8 (m / 2), chunk
    // 2 mt + (m & 1)); B = P^T by ldmatrix (matrix m: rows + 8 (m / 2),
    // keys + 8 (m & 1))
    if (w * MTW < Gm::MT) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 c = *reinterpret_cast<const float2*>(
            corr_s + 8 * nt + 2 * tig);
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          acc[i][nt][0] *= c.x;
          acc[i][nt][1] *= c.y;
          acc[i][nt][2] *= c.x;
          acc[i][nt][3] *= c.y;
        }
      }
      const int vk = (lane & 7) + ((lane >> 4) << 3);
      const int vc = (lane >> 3) & 1;
      const int pn = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < Gm::KM; ++kk) {
        if (kr + 16 * kk >= k1) break;
        const int key = 16 * kk + vk;
        const unsigned char* vrow = st + key * ROWB;
        uint32_t a[MTW][4];
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          const int mt = min(w * MTW + i, Gm::MT - 1);
          ldmatrix_x4_trans(a[i], vrow + (((2 * mt + vc) ^ (key & 7)) << 4));
        }
        const int pk = 16 * kk + 8 * vc;
#pragma unroll
        for (int np = 0; np < Gm::NP; ++np) {
          if (q0 + 16 * np / H >= qv) break;    // padding queries: P is 0
          uint32_t bh[4], bl[4];
          const int n = 16 * np + pn;
          ldmatrix_x4(bh, phi + n * PST + pk);
          ldmatrix_x4(bl, plo + n * PST + pk);
#pragma unroll
          for (int i = 0; i < MTW; ++i) {
            if (w * MTW + i >= Gm::MT) break;
            mma_bf16(acc[i][2 * np], a[i], bh[0], bh[1]);
            mma_bf16(acc[i][2 * np], a[i], bl[0], bl[1]);
            mma_bf16(acc[i][2 * np + 1], a[i], bh[2], bh[3]);
            mma_bf16(acc[i][2 * np + 1], a[i], bl[2], bl[3]);
          }
        }
      }
    }
    __syncthreads();                        // stage j % 2, sc and P consumed
    if (j + 2 < rounds) issue(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                          // every warp is off the stages

  // the block's (m, l, acc) through shared memory: O [NQ][OS], then m, l
  float* O = reinterpret_cast<float*>(mp_smem);
  float* Mh = O + NQ * OS;
  float* Lh = Mh + NQ;
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int mt = w * MTW + i;
    if (mt >= Gm::MT) break;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* o = O + (8 * nt + 2 * tig) * OS + 16 * mt + gid;
      o[0] = acc[i][nt][0];
      o[OS] = acc[i][nt][1];
      o[8] = acc[i][nt][2];
      o[OS + 8] = acc[i][nt][3];
    }
  }
  if (sn < NQ) {
    const float lt = quad_sum(l);
    if (sp == 0) {
      Mh[sn] = m;
      Lh[sn] = lt;
    }
  }
  __syncthreads();

  // out [S, H, R]: row n of the block is out row q0 H + n, written while
  // its query is in the chunk (q0 + n / H < S); padding queries 0
  const int64_t orow = static_cast<int64_t>(q0) * H;
  const int nrows = min(NQ, (S - q0) * H);
  if (splits == 1) {
    for (int i = tid; i < nrows * (R / 8); i += MP_THREADS) {
      const int n = i / (R / 8), c = (i % (R / 8)) * 8;
      const float inv =
          q0 + n / H < n_valid ? 1.f / fmaxf(Lh[n], 1e-30f) : 0.f;
      const float* o = O + n * OS + c;
      uint4 v;
      v.x = pack_bf16(o[0] * inv, o[1] * inv);
      v.y = pack_bf16(o[2] * inv, o[3] * inv);
      v.z = pack_bf16(o[4] * inv, o[5] * inv);
      v.w = pack_bf16(o[6] * inv, o[7] * inv);
      *reinterpret_cast<uint4*>(out + (orow + n) * R + c) = v;
    }
    return;
  }

  // splits > 1: the query block's splits are one thread-block cluster;
  // each block merges its share of the [NQ][R] outputs from every split's
  // O, m and l in the peers' shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                           // every split's (O, m, l)
  float* wt = Lh + NQ;                      // [NQ][splits]
  float* inv = wt + NQ * splits;            // [NQ]
  if (tid < NQ) {
    float M = NEG_INF;
    for (int v = 0; v < splits; ++v)
      M = fmaxf(M, cluster.map_shared_rank(Mh, v)[tid]);
    float L = 0.f;
    for (int v = 0; v < splits; ++v) {
      const float x = ex2(cluster.map_shared_rank(Mh, v)[tid] - M);
      wt[tid * splits + v] = x;
      L += x * cluster.map_shared_rank(Lh, v)[tid];
    }
    inv[tid] = q0 + tid / H < n_valid ? 1.f / fmaxf(L, 1e-30f) : 0.f;
  }
  __syncthreads();
  const int n4 = nrows * (R / 4);           // float4s of the block's rows
  for (int i = z * n4 / splits + tid; i < (z + 1) * n4 / splits;
       i += MP_THREADS) {
    const int n = i / (R / 4), c = (i % (R / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = 0; v < splits && q0 + n / H < n_valid; ++v) {
      const float x = wt[n * splits + v];
      if (x == 0.f) continue;               // a split with no live key: O 0
      const float4 b = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(O, v) + n * OS + c);
      a.x += x * b.x;
      a.y += x * b.y;
      a.z += x * b.z;
      a.w += x * b.w;
    }
    const float s = inv[n];
    *reinterpret_cast<uint2*>(out + (orow + n) * R + c) =
        make_uint2(pack_bf16(a.x * s, a.y * s), pack_bf16(a.z * s, a.w * s));
  }
  cluster.sync();                           // no peer reads this block now
}

template <int H, int R, int RP>
int launch_mma(const void* q_lat, const void* q_rope, const void* ckv,
               const void* krope, const void* page_row, void* out, int S,
               int ps, int start, int n_valid, float scale, int splits,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = paged_mla_prefill_kernel_mma<H, R, RP>;
  const size_t smem = MlaPrefillGeom<H, R, RP>::smem(
      (start + n_valid + ps - 1) / ps);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  // grid (query blocks, splits), the splits of a query block one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S + MP_QG - 1) / MP_QG, splits);
  cfg.blockDim = dim3(MP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q_lat),
      static_cast<const bf16*>(q_rope), static_cast<const bf16*>(ckv),
      static_cast<const bf16*>(krope), static_cast<const int*>(page_row),
      static_cast<bf16*>(out), S, ps, start, n_valid, scale * LOG2E));
}

template <int H, int R, int RP>
int launch_f32(const void* q_lat, const void* q_rope, const void* ckv,
               const void* krope, const void* page_row, void* out, int S,
               int ps, int n_table, int start, int n_valid, float scale,
               cudaStream_t stream) {
  const size_t smem = MlaGeom<H, R, RP>::smem_floats(ps) * sizeof(float);
  auto kernel = paged_mla_prefill_kernel<float, H, R, RP>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<S, MLA_THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const float*>(ckv), static_cast<const float*>(krope),
      static_cast<const int*>(page_row), static_cast<float*>(out), ps,
      n_table, start, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (dtype, geometry): bf16 to the split tensor-core kernel,
// fp32 to the scalar body (splits = 1)
template <int H, int R, int RP>
int launch_dtype(int dtype, const void* q_lat, const void* q_rope,
                 const void* ckv, const void* krope, const void* row,
                 void* out, int S, int ps, int n_table, int start,
                 int n_valid, float scale, int splits,
                 cudaStream_t stream) {
  if (dtype == DTYPE_BF16)
    return launch_mma<H, R, RP>(q_lat, q_rope, ckv, krope, row, out, S, ps,
                                start, n_valid, scale, splits, stream);
  if (dtype == DTYPE_F32 && splits == 1)
    return launch_f32<H, R, RP>(q_lat, q_rope, ckv, krope, row, out, S, ps,
                                n_table, start, n_valid, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

// q_lat [S, H, R]; q_rope [S, H, rp]; ckv_pages [P, ps, R]; krope_pages
// [P, ps, rp]; page_row [n_table] int32, start + n_valid <= n_table * ps;
// out [S, H, R]; start / n_valid as in the header note.  bf16 only:
// splits > 1 (at most 8, a portable cluster) splits every query block's
// key tiles over blockIdx.y; fp32 takes splits = 1.  Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int paged_mla_prefill_launch(const void* q_lat, const void* q_rope,
                                        const void* ckv_pages,
                                        const void* krope_pages,
                                        const void* page_row, void* out,
                                        int S, int H, int R, int rp, int ps,
                                        int n_table, int start, int n_valid,
                                        float scale, int dtype, int splits,
                                        void* stream) {
  using namespace repro_torch;
  if (ps < 8 || ps > 64 || S < 1 || n_valid > S || n_valid < 0 ||
      start < 0 || start + n_valid > n_table * ps || splits < 1 ||
      splits > MP_MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 16 && R == 512 && rp == 64)     // deepseek-v2-lite, full width
    return launch_dtype<16, 512, 64>(dtype, q_lat, q_rope, ckv_pages,
                                     krope_pages, page_row, out, S, ps,
                                     n_table, start, n_valid, scale, splits,
                                     s);
  if (H == 4 && R == 32 && rp == 8)        // the smoke geometry
    return launch_dtype<4, 32, 8>(dtype, q_lat, q_rope, ckv_pages,
                                  krope_pages, page_row, out, S, ps, n_table,
                                  start, n_valid, scale, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
