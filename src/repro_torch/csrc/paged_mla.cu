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
// What bounds it on an H100: bytes, and at the serving shapes latency.  A
// slot reads each latent row it holds once, (R + rp) x 2 = 1,152 bytes a
// key at deepseek-v2-lite's width (H 16, R 512, rp 64), and does
// 2 H (2R + rp) flop a key: ~32 flop per byte, far under the ~295 where
// the tensor cores would be the limit.  The drive's 8 slots of <= 128 keys
// are <= 1.2 MB of pages, ~0.3 us at 3.35 TB/s; what the card spends is
// the critical path of the longest slot.  The first port ran one block a
// slot (8 blocks on 132 SMs), walked pages in series through synchronous
// fp32 tiles with four barriers a page, scored each (head, key) pair as
// a 576-long scalar dot product on one thread and ran each head's
// softmax on one thread: 0.17-0.19 ms at the kernel phase's lengths,
// 0.089 ms a launch in the deepseek drive.
//
// The bf16 design (paged_mla_decode_kernel_mma):
//  * Split over pages.  Grid (slots, splits): split z of a slot takes
//    pages [z n / splits, (z + 1) n / splits) of its n live pages (n from
//    `lengths`, read on the device), so the count, `mla_decode_splits` in
//    kernels/paged_attention/kernel.py, is a function of the shapes and
//    the SM count only and costs the host no sync.
//  * Rounds of 64 keys through a two-stage cp.async pipeline.  Each key's
//    [ckv | krope] row (padded with zeros to a multiple of 64 elements) is
//    gathered once into a bf16 tile, its 16-byte chunks swizzled by the
//    row (c ^ (row % 8)) so every ldmatrix below reads distinct banks.
//    Q and the first two rounds are in flight together; round j + 2 is
//    issued as soon as round j is consumed.
//  * Scores on the tensor cores, keys as M and heads as N: each warp takes
//    16 keys of the round, S^T = [ckv | krope] [q_lat | q_rope]^T in 36
//    k-steps of mma.sync m16n8k16 (Q stays in shared memory and is read by
//    ldmatrix: as registers it would take 144 a lane), into a [head][key]
//    score tile.
//  * P V split by value columns.  Every warp reads the whole round's
//    scores, runs the online softmax of the heads its lanes hold (a quad
//    of lanes a head, the same arithmetic in every warp) and keeps P^T as
//    hi + lo bf16 fragments (fp32 P to ~2^-18; bf16 P alone moves outputs
//    by a bf16 ulp); warp w owns latent columns [R w / 4, R (w + 1) / 4):
//    O^T[128, 16] += ckv^T P^T, ckv^T read by ldmatrix.trans from the same
//    tile, 64 fp32 registers a lane.  Masked keys (past the split's end:
//    zero-filled rows) give exactly 0 while a head's max is NEG_INF.
//  * Merge in the same launch, in a cluster.  The splits of a slot are one
//    thread-block cluster (at most 8 blocks, the portable size), so the
//    merge needs no workspace, counter or second pass: each block leaves
//    its (O, m, l) in its shared memory, and after a cluster barrier each
//    merges 1 / splits of the [H][R] outputs from the peers' shared memory
//    (distributed shared memory) as merge_partials_ref does.  K1's way,
//    an fp32 workspace in L2 merged by the last block to finish, costs a
//    few L2 round trips over 32 KB of partials a split here, as much as
//    the loads a split saves.  An empty split's (NEG_INF, 0, 0) weighs 0;
//    a slot of length 0 comes out 0.
//
// fp32 keeps the scalar body of the first port (paged_mla_common.cuh's
// mla_attend, one block a slot, unsplit), chosen by dtype: it is what the
// fp32 arm runs, holding teacher-forced logits within 1e-3 of the plain
// path, and stays within 1e-5 of the plain version.
#include <cooperative_groups.h>

#include "attn_tiles.cuh"
#include "paged_mla_common.cuh"

namespace repro_torch {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// fp32: the scalar body, one block a slot
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: mma.sync, split over pages
// ---------------------------------------------------------------------------

constexpr int MD_KEYS = 64;                 // keys a round, 16 a warp
constexpr int MD_WARPS = 4;
constexpr int MD_THREADS = MD_WARPS * 32;
// the most splits a launch takes: the splits of a slot are one cluster,
// and 8 blocks is the portable cluster size
constexpr int MD_MAX_SPLITS = 8;

template <int H, int R, int RP>
struct MlaMmaGeom {
  static constexpr int KD = (R + RP + 63) / 64 * 64;  // padded row, elements
  static constexpr int ROWB = KD * 2;                 // bytes of a row
  static constexpr int CH = KD / 8;                   // 16-byte chunks a row
  static constexpr int KSTEPS = KD / 16;              // a multiple of 4
  static constexpr int NTH = (H + 7) / 8;             // 8-head n-tiles
  static constexpr int HP = NTH * 8;                  // heads, padded
  static constexpr int MT = R / 16;                   // 16-column tiles of O
  static constexpr int MTW = (MT + MD_WARPS - 1) / MD_WARPS;   // ... a warp
  static constexpr int STAGE = MD_KEYS * ROWB;
  static constexpr int QBYTES = HP * ROWB;
  static constexpr int SS = MD_KEYS + 4;              // floats a score row
  static constexpr int OS = R + 4;                    // floats an output row
  static_assert(R % 16 == 0 && (R + RP) % 8 == 0, "16-byte rows");
  static_assert(NTH <= 2, "at most 16 heads");
  static_assert((MD_KEYS * CH) % MD_THREADS == 0, "whole chunks a thread");
  static_assert(HP * OS * 4 + 2 * HP * 4 + (MD_MAX_SPLITS + 1) * H * 4 <=
                    2 * STAGE,
                "the epilogue and the merge fit the stages");

  static size_t smem(int n_table, int splits) {
    return 2 * static_cast<size_t>(STAGE) + QBYTES + HP * SS * 4 +
           ((n_table + splits - 1) / splits + 1) * sizeof(int);
  }
};

template <int H, int R, int RP>
__global__ void __launch_bounds__(MD_THREADS, 1)
paged_mla_decode_kernel_mma(const __nv_bfloat16* __restrict__ q_lat,
                            const __nv_bfloat16* __restrict__ q_rope,
                            const __nv_bfloat16* __restrict__ ckv_pages,
                            const __nv_bfloat16* __restrict__ krope_pages,
                            const int* __restrict__ page_table,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, int ps,
                            int n_table, float scale_log2) {
  using Gm = MlaMmaGeom<H, R, RP>;
  constexpr int ROWB = Gm::ROWB, CH = Gm::CH, NTH = Gm::NTH, SS = Gm::SS;
  constexpr int MTW = Gm::MTW, OS = Gm::OS;
  // (not `smem`: mla_attend declares that name as float in this file)
  extern __shared__ __align__(128) unsigned char md_smem[];
  unsigned char* stages = md_smem;                      // [2][64 keys][KD]
  unsigned char* qs = md_smem + 2 * Gm::STAGE;          // [HP][KD]
  float* sc = reinterpret_cast<float*>(qs + Gm::QBYTES);   // [HP][SS]
  int* tbl = reinterpret_cast<int*>(sc + Gm::HP * SS);  // the split's pages

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int slot = blockIdx.x;
  const int splits = gridDim.y, z = blockIdx.y;

  // the slot's live keys, and this split's pages [p0, p1) and keys [k0, k1)
  const int key_end = max(0, min(lengths[slot], n_table * ps));
  const int n = (key_end + ps - 1) / ps;
  const int p0 = z * n / splits, p1 = (z + 1) * n / splits;
  const int k0 = p0 * ps, k1 = min(p1 * ps, key_end);
  const int rounds = k1 > k0 ? (k1 - k0 + MD_KEYS - 1) / MD_KEYS : 0;
  const bool ps_pow2 = (ps & (ps - 1)) == 0;
  const int ps_shift = __ffs(ps) - 1;

  const int* row = page_table + static_cast<int64_t>(slot) * n_table;
  for (int i = tid; i < p1 - p0; i += MD_THREADS) tbl[i] = row[p0 + i];
  __syncthreads();

  // Q rows [q_lat | q_rope | 0], heads past H zero
  {
    const __nv_bfloat16* ql = q_lat + static_cast<int64_t>(slot) * H * R;
    const __nv_bfloat16* qr = q_rope + static_cast<int64_t>(slot) * H * RP;
    for (int i = tid; i < Gm::HP * CH; i += MD_THREADS) {
      const int hh = i / CH, c = i % CH;
      const __nv_bfloat16* src = nullptr;
      if (hh < H) {
        if (c < R / 8)
          src = ql + hh * R + 8 * c;
        else if (c < (R + RP) / 8)
          src = qr + hh * RP + 8 * (c - R / 8);
      }
      cp_async16(qs + hh * ROWB + ((c ^ (hh & 7)) << 4), src ? src : q_lat,
                 src != nullptr);
    }
  }
  // round j's rows into stage j % 2: key kr + r, its 16-byte chunk c at
  // chunk c ^ (r % 8); rows past the split's keys and the row padding
  // zero-filled (never read from the pages)
  auto issue = [&](int j) {
    unsigned char* dst = stages + (j & 1) * Gm::STAGE;
    const int kr = k0 + j * MD_KEYS;
#pragma unroll 4
    for (int k = 0; k < MD_KEYS * CH / MD_THREADS; ++k) {
      const int i = tid + k * MD_THREADS;
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
  // both stages in flight at once: Q with round 0, then round 1
  if (rounds > 0) issue(0);
  cp_async_commit();
  if (rounds > 1) issue(1);
  cp_async_commit();

  // this lane's state: heads gid + 8 nt (softmax), and O^T columns
  // 16 mt + gid (+ 8) of heads 8 nt + 2 tig (+ 1), mt = w * MTW + i
  float m[NTH], l[NTH], acc[MTW][NTH][4];
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt) {
    m[nt] = NEG_INF;
    l[nt] = 0.f;
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  }

  for (int j = 0; j < rounds; ++j) {
    cp_async_wait<1>();                     // one group a round: j landed
    __syncthreads();
    const unsigned char* st = stages + (j & 1) * Gm::STAGE;
    const int kr = k0 + j * MD_KEYS;

    // S^T (this warp's 16 keys x HP heads) = K Q^T; A = K rows by
    // ldmatrix (matrix m: keys + 8 (m & 1), chunk 2 ks + m / 2), B = Q^T
    // (matrix m: heads + 8 (m / 2), chunk 2 ks + (m & 1))
    if (kr + 16 * w < k1) {
      // two sums (even and odd k-steps) halve the chain of dependent mmas
      float s[2][NTH][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt)
          s[u][nt][0] = s[u][nt][1] = s[u][nt][2] = s[u][nt][3] = 0.f;
      const int ak = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int bh = (lane & 7) + (NTH > 1 ? (lane >> 4) << 3 : 0);
      const unsigned char* arow = st + ak * ROWB;
      const unsigned char* brow = qs + bh * ROWB;
#pragma unroll 3
      for (int k2 = 0; k2 < Gm::KSTEPS; k2 += 2)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t a[4], b[4];
          const int ac = 2 * (k2 + u) + (lane >> 4);
          const int bc = 2 * (k2 + u) + ((lane >> 3) & 1);
          ldmatrix_x4(a, arow + ((ac ^ (ak & 7)) << 4));
          ldmatrix_x4(b, brow + ((bc ^ (bh & 7)) << 4));
          mma_bf16(s[u][0], a, b[0], b[1]);
          if constexpr (NTH > 1) mma_bf16(s[u][1], a, b[2], b[3]);
        }
      // scores in log2 units into the [head][key] tile
      const int key = 16 * w + gid;
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
        float* h0 = sc + (8 * nt + 2 * tig) * SS + key;
        h0[0] = (s[0][nt][0] + s[1][nt][0]) * scale_log2;
        h0[SS] = (s[0][nt][1] + s[1][nt][1]) * scale_log2;
        h0[8] = (s[0][nt][2] + s[1][nt][2]) * scale_log2;
        h0[SS + 8] = (s[0][nt][3] + s[1][nt][3]) * scale_log2;
      }
    }
    __syncthreads();                        // the round's scores

    // online softmax: lane (gid, tig) holds keys 16 kk + 2 tig (+1, +8,
    // +9) of heads gid + 8 nt — the B fragments of P^T
    const int nkk = min(4, (k1 - kr + 15) / 16);   // key steps with a live key
    float p[4][NTH][4];
    float corr[NTH];
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      const float* srow = sc + (8 * nt + gid) * SS;
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = 16 * kk + 2 * tig;
        float2 x0 = make_float2(NEG_INF, NEG_INF), x1 = x0;
        if (kk < nkk) {
          x0 = *reinterpret_cast<const float2*>(srow + c);
          x1 = *reinterpret_cast<const float2*>(srow + c + 8);
        }
        const int pos = kr + c;
        p[kk][nt][0] = pos < k1 ? x0.x : NEG_INF;
        p[kk][nt][1] = pos + 1 < k1 ? x0.y : NEG_INF;
        p[kk][nt][2] = pos + 8 < k1 ? x1.x : NEG_INF;
        p[kk][nt][3] = pos + 9 < k1 ? x1.y : NEG_INF;
#pragma unroll
        for (int e = 0; e < 4; ++e) mx = fmaxf(mx, p[kk][nt][e]);
      }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[nt], mx);
      const float base = m_new == NEG_INF ? 0.f : m_new;
      corr[nt] = ex2(m[nt] - base);
      m[nt] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[kk][nt][e] = ex2(p[kk][nt][e] - base);
          sum += p[kk][nt][e];
        }
      l[nt] = l[nt] * corr[nt] + sum;
    }
    // O^T's heads 8 nt + 2 tig (+ 1) take the factors of lanes 8 tig (+ 4)
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      const float ca = __shfl_sync(0xffffffffu, corr[nt], 8 * tig);
      const float cb = __shfl_sync(0xffffffffu, corr[nt], 8 * tig + 4);
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        acc[i][nt][0] *= ca;
        acc[i][nt][1] *= cb;
        acc[i][nt][2] *= ca;
        acc[i][nt][3] *= cb;
      }
    }

    // O^T += ckv^T P^T over the live key steps, P^T as hi + lo bf16; A =
    // ckv^T by ldmatrix.trans (matrix m: keys + 8 (m / 2), chunk
    // 2 mt + (m & 1))
    const int vk = (lane & 7) + ((lane >> 4) << 3);
    const int vc = (lane >> 3) & 1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= nkk) break;
      uint32_t bhi[NTH][2], blo[NTH][2];
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float x = p[kk][nt][2 * b], y = p[kk][nt][2 * b + 1];
          const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hv);
          bhi[nt][b] = *reinterpret_cast<const uint32_t*>(&hv);
          blo[nt][b] = pack_bf16(x - hf.x, y - hf.y);
        }
      const int key = 16 * kk + vk;
      const unsigned char* vrow = st + key * ROWB;
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        const int mt = w * MTW + i;
        if (mt >= Gm::MT) break;
        uint32_t a[4];
        ldmatrix_x4_trans(a, vrow + (((2 * mt + vc) ^ (key & 7)) << 4));
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt) {
          mma_bf16(acc[i][nt], a, bhi[nt][0], bhi[nt][1]);
          mma_bf16(acc[i][nt], a, blo[nt][0], blo[nt][1]);
        }
      }
    }
    __syncthreads();                        // stage j % 2 and sc consumed
    if (j + 2 < rounds) issue(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                          // every warp is off the stages

  // the block's (m, l, acc) through shared memory: O [HP][OS], then m, l
  float* O = reinterpret_cast<float*>(md_smem);
  float* Mh = O + Gm::HP * OS;
  float* Lh = Mh + Gm::HP;
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int mt = w * MTW + i;
    if (mt >= Gm::MT) break;
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      float* o = O + (8 * nt + 2 * tig) * OS + 16 * mt + gid;
      o[0] = acc[i][nt][0];
      o[OS] = acc[i][nt][1];
      o[8] = acc[i][nt][2];
      o[OS + 8] = acc[i][nt][3];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt) {
    const float lt = quad_sum(l[nt]);
    if (w == 0 && tig == 0) {
      Mh[8 * nt + gid] = m[nt];
      Lh[8 * nt + gid] = lt;
    }
  }
  __syncthreads();

  const int64_t orow = static_cast<int64_t>(slot) * H;   // out [slots, H, R]
  if (splits == 1) {
    for (int i = tid; i < H * R / 8; i += MD_THREADS) {
      const int hh = i / (R / 8), c = (i % (R / 8)) * 8;
      const float inv = 1.f / fmaxf(Lh[hh], 1e-30f);
      const float* o = O + hh * OS + c;
      uint4 v;
      v.x = pack_bf16(o[0] * inv, o[1] * inv);
      v.y = pack_bf16(o[2] * inv, o[3] * inv);
      v.z = pack_bf16(o[4] * inv, o[5] * inv);
      v.w = pack_bf16(o[6] * inv, o[7] * inv);
      *reinterpret_cast<uint4*>(out + (orow + hh) * R + c) = v;
    }
    return;
  }

  // splits > 1: the slot's splits are one thread-block cluster; each
  // block merges its share of the [H][R] outputs from every split's O, m
  // and l in the peers' shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                           // every split's (O, m, l)
  float* wt = Lh + Gm::HP;                  // [H][splits]
  float* inv = wt + H * splits;             // [H]
  if (tid < H) {
    float M = NEG_INF;
    for (int v = 0; v < splits; ++v)
      M = fmaxf(M, cluster.map_shared_rank(Mh, v)[tid]);
    float L = 0.f;
    for (int v = 0; v < splits; ++v) {
      const float x = ex2(cluster.map_shared_rank(Mh, v)[tid] - M);
      wt[tid * splits + v] = x;
      L += x * cluster.map_shared_rank(Lh, v)[tid];
    }
    inv[tid] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  constexpr int N4 = H * R / 4;             // float4s of the output
  for (int i = z * N4 / splits + tid; i < (z + 1) * N4 / splits;
       i += MD_THREADS) {
    const int hh = i / (R / 4), c = (i % (R / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = 0; v < splits; ++v) {
      const float x = wt[hh * splits + v];
      if (x == 0.f) continue;               // an empty split: O is 0
      const float4 b = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(O, v) + hh * OS + c);
      a.x += x * b.x;
      a.y += x * b.y;
      a.z += x * b.z;
      a.w += x * b.w;
    }
    const float s = inv[hh];
    *reinterpret_cast<uint2*>(out + (orow + hh) * R + c) =
        make_uint2(pack_bf16(a.x * s, a.y * s), pack_bf16(a.z * s, a.w * s));
  }
  cluster.sync();                           // no peer reads this block now
}

template <int H, int R, int RP>
int launch_mma(const void* q_lat, const void* q_rope, const void* ckv,
               const void* krope, const void* page_table, const void* lengths,
               void* out, int slots, int ps, int n_table, float scale,
               int splits, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = paged_mla_decode_kernel_mma<H, R, RP>;
  const size_t smem = MlaMmaGeom<H, R, RP>::smem(n_table, splits);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  // grid (slots, splits), the splits of a slot one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slots, splits);
  cfg.blockDim = dim3(MD_THREADS);
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
      static_cast<const bf16*>(krope), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), ps,
      n_table, scale * LOG2E));
}

template <int H, int R, int RP>
int launch_f32(const void* q_lat, const void* q_rope, const void* ckv,
               const void* krope, const void* page_table, const void* lengths,
               void* out, int slots, int ps, int n_table, float scale,
               cudaStream_t stream) {
  const size_t smem = MlaGeom<H, R, RP>::smem_floats(ps) * sizeof(float);
  auto kernel = paged_mla_decode_kernel<float, H, R, RP>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<slots, MLA_THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const float*>(ckv), static_cast<const float*>(krope),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<float*>(out), ps, n_table, scale);
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (dtype, geometry): bf16 to the split tensor-core kernel,
// fp32 to the scalar body (splits = 1)
template <int H, int R, int RP>
int launch_dtype(int dtype, const void* q_lat, const void* q_rope,
                 const void* ckv, const void* krope, const void* table,
                 const void* lengths, void* out, int slots, int ps,
                 int n_table, float scale, int splits,
                 cudaStream_t stream) {
  if (dtype == DTYPE_BF16)
    return launch_mma<H, R, RP>(q_lat, q_rope, ckv, krope, table, lengths,
                                out, slots, ps, n_table, scale, splits,
                                stream);
  if (dtype == DTYPE_F32 && splits == 1)
    return launch_f32<H, R, RP>(q_lat, q_rope, ckv, krope, table, lengths,
                                out, slots, ps, n_table, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

// q_lat [slots, H, R]; q_rope [slots, H, rp]; ckv_pages [P, ps, R];
// krope_pages [P, ps, rp]; page_table [slots, n_table] int32; lengths
// [slots] int32; out [slots, H, R].  bf16 only: splits > 1 (at most 8,
// a portable cluster) splits every slot's live pages over blockIdx.y;
// fp32 takes splits = 1.  Returns the cudaError_t of the launch (0 =
// queued).
extern "C" int paged_mla_launch(const void* q_lat, const void* q_rope,
                                const void* ckv_pages,
                                const void* krope_pages,
                                const void* page_table, const void* lengths,
                                void* out, int slots, int H, int R, int rp, int ps,
                                int n_table, float scale, int dtype,
                                int splits, void* stream) {
  using namespace repro_torch;
  if (ps < 8 || ps > 64 || slots < 1 || splits < 1 ||
      splits > MD_MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 16 && R == 512 && rp == 64)     // deepseek-v2-lite, full width
    return launch_dtype<16, 512, 64>(dtype, q_lat, q_rope, ckv_pages,
                                     krope_pages, page_table, lengths, out,
                                     slots, ps, n_table, scale, splits, s);
  if (H == 4 && R == 32 && rp == 8)        // the smoke geometry
    return launch_dtype<4, 32, 8>(dtype, q_lat, q_rope, ckv_pages,
                                  krope_pages, page_table, lengths, out,
                                  slots, ps, n_table, scale, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
