// Paged decode attention for Hopper (sm_90a): contiguous pages (K1), ring-
// wrapped window pages (K4), fp or int8 pages (K8).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_attention_kernel` / `_paged_kernel`: one query token per decode
// slot attends the pages its page-table row names, with an online softmax
// over pages and the output `acc / max(l, 1e-30)`.
//   * contiguous pages (window == 0): keys masked by `idx < length`, pages
//     past `length` skipped;
//   * ring pages (window > 0, K4): the row is a ring of window / ps cells;
//     cell idx holds position p = cur - floormod(cur - idx, window) with
//     cur = length - 1, and p >= 0 is the mask (it is also the sliding-
//     window mask).  Cells run to min(length, window); pages past them are
//     skipped.  The modulo is a floor modulo: on the straddling page of a
//     slot shorter than the window, cur - idx is negative, and C's `%`
//     would unmask cells that were never written;
//   * int8 pages (K8): one bf16 scale per (page, offset, kv-head) row for K
//     and for V.  Each raw score is multiplied by its key's scale after the
//     dot product and before the mask; each probability by its value's
//     scale before the PV product; the denominator l is not scaled (as
//     `_paged_kernel` does).
//
// What bounds it on an H100: bytes.  A slot reads each page it holds once
// (ps x hd bf16 for K and again for V per kv-head; half that plus 2 x ps
// scale bytes for int8 pages) and does one multiply-add per query head for
// each element it reads — G flop per byte of bf16 pages, 5-6 on the served
// models, far below the ~295 flop/byte where the tensor cores would become
// the limit.  Reaching the bytes bound is a matter of bytes in flight
// (~5 MB across the card at 3.35 TB/s) and of spreading a few long slots
// over all 132 SMs, so the design ("flash decoding"):
//
//  * Split over pages.  Grid (slots, KV x G-groups, splits): split z of a
//    slot takes pages [z n / splits, (z + 1) n / splits) of its n live
//    pages (n = ceil(cells / ps), read from `lengths` on the device), so a
//    4096-token ring slot and a 1-token slot cost the same critical path
//    once the count is picked.  The count is a function of the shapes
//    (`decode_splits` in kernels/paged_attention/kernel.py), never of the
//    lengths, so choosing it costs the host no sync.
//  * Warps, not blocks, walk keys.  A block's warps (4, or fewer where the
//    pipeline would not fit) take 16-key rounds of the split in turn, each
//    warp with its own cp.async pipeline of 2-4 rounds in shared memory
//    and its own online softmax state: no block barrier in the loop.
//    Rows land in their own type (bf16, fp32, or raw int8 bytes plus the
//    32-bit words holding their bf16 scales), gathered row by row through
//    the split's page-table entries (copied to shared memory first, so no
//    copy waits on a table read), and are widened at use.
//  * All 16 keys of a round at once, on the tensor cores for bf16 queries.
//    mma.sync m16n8k16 with the round's 16 keys as the M rows and up to 8
//    query heads as N, so no row is padding: S^T = K Q^T (Q's fragments in
//    registers for the whole walk), then O^T += V^T P^T (V through
//    ldmatrix.trans; P^T through shared memory, as hi + lo bf16 operands
//    that carry fp32 P to ~2^-18, since bf16 P alone moves outputs near 2
//    by a bf16 ulp).  A round's max is three shuffles a head; each lane
//    keeps the softmax state of its two heads.  int8 pages: K widened to
//    bf16 in registers, V to a bf16 tile in shared memory, both exactly,
//    by the byte-permute conversion.  fp32 queries take a scalar body over
//    the same pipeline: lane (t, part) scores key t against every head over
//    half the head dim, one shuffle completes a score, and in P V each
//    lane owns hd / 32 output columns.  K / V rows sit swizzled in 16-byte
//    chunks so each access hits distinct banks.  Masked keys give exactly
//    0 while a head's max is still NEG_INF (the exponent is taken against
//    0 then).
//  * Merge in the same launch.  The block folds its warps' states; with
//    splits > 1 it writes fp32 (m, l, acc) to a workspace, and the last
//    block of a (slot, kv-head, G-group) to finish (a device counter it
//    resets) merges the splits as merge_partials_ref does.  An empty split
//    writes (NEG_INF, 0, 0); a slot of length 0 comes out 0.
#include "attn_tiles.cuh"

#include <algorithm>

namespace repro_torch {

constexpr int PD_KEYS = 16;        // keys a round (one warp's unit of work)
constexpr int PD_MAXG = 8;         // query heads a block holds (G-groups)
constexpr int PD_MAX_WARPS = 4;
constexpr int PD_MAX_STAGES = 4;
// the most splits a launch takes (the final merge's weights fit the
// smallest block's shared memory)
constexpr int PD_MAX_SPLITS = 64;
// shared memory for the pipeline stages of a block: at most ~half the SM's,
// so two blocks (8 warps) share an SM
constexpr int PD_STAGE_BUDGET = 110 * 1024;

// 4-byte asynchronous copy global -> shared (pred false zero-fills)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// wait until at most n (0..2) committed groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// the fp32 values of one 32-bit word of page elements
__device__ __forceinline__ void widen_word(uint32_t w, float* f, float) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void widen_word(uint32_t w, float* f, int8_t) {
  int8x4_to_f32(w, f);
}

// N fp32 or int8 page elements at src (shared memory, N * sizeof(PT)
// bytes aligned to their size, 2..32) as fp32 (the scalar body)
template <typename PT, int N>
__device__ __forceinline__ void load_widen(const PT* src, float (&f)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(PT));
  constexpr int PER_WORD = 4 / static_cast<int>(sizeof(PT));
  if constexpr (BYTES == 2) {                 // two int8 values
    float t[4];
    widen_word(*reinterpret_cast<const uint16_t*>(src), t, PT());
    f[0] = t[0];
    f[1] = t[1];
  } else {
    uint32_t w[BYTES / 4];
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(src)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(src);
    }
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i)
      widen_word(w[i], f + i * PER_WORD, PT());
  }
}

// Pipeline geometry of a (query type, page type, head dim): the bytes of
// one round's stage (K tile, V tile, int8 scale words), the per-warp
// scratch (probabilities; for int8 pages on the tensor cores also the V
// tile widened to bf16), where a row's 16-byte chunks sit, and the warps
// and stages a block runs: 4 warps with the deepest pipeline (<= 4 rounds)
// that fits PD_STAGE_BUDGET, else fewer warps.
template <typename T, typename PT, int HD>
struct DecodeGeom {
  static constexpr bool MMA = sizeof(T) == 2;     // bf16: tensor cores
  static constexpr bool QUANT = sizeof(PT) == 1;
  static constexpr int ROWB = HD * static_cast<int>(sizeof(PT));
  static constexpr int CPR = ROWB / 16;       // 16-byte chunks a row
  static constexpr int VEC = 16 / static_cast<int>(sizeof(PT));
  static constexpr int TILE = PD_KEYS * ROWB;
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * PD_KEYS * 4 : 0);
  // per warp: P (scalar [16 keys][8 heads]; tensor cores [8 heads][24])
  // then, for int8 pages on the tensor cores, the bf16 V tile
  static constexpr int P_FLOATS = 8 * 24;
  static constexpr int SCRATCH =
      P_FLOATS * 4 + (MMA && QUANT ? PD_KEYS * HD * 2 : 0);
  // chunk c of K row r sits at chunk c ^ ksw(r), of V row r at c ^ vsw(r):
  // the lanes of one shared-memory access then read distinct banks
  // (scalar: 4 rows x 2 halves a quarter-warp; tensor cores: bf16 K 4 rows
  // x 32 bytes a half-warp, int8 K 8 rows x 16 bytes, V 8 rows of an
  // ldmatrix)
  static __device__ __forceinline__ int ksw(int r) {
    if constexpr (MMA && QUANT) return r & (CPR >= 8 ? 7 : 3);
    return CPR >= 8 ? (r & 3) << 1 : ((r >> 1) & 1) << 1;
  }
  static __device__ __forceinline__ int vsw(int r) {
    return MMA && !QUANT ? r & 7 : 0;
  }
  static void pick(int& warps, int& stages) {
    for (warps = PD_MAX_WARPS; warps > 1; warps /= 2)
      if (PD_STAGE_BUDGET / (warps * STAGE) >= 2) break;
    stages = PD_STAGE_BUDGET / (warps * STAGE);
    stages = stages > PD_MAX_STAGES ? PD_MAX_STAGES
                                    : (stages < 2 ? 2 : stages);
  }
};

template <typename T, typename PT, int HD>
__global__ void __launch_bounds__(PD_MAX_WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const PT* __restrict__ k_pages,
                    const PT* __restrict__ v_pages,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ ws, unsigned* __restrict__ counters,
                    int KV, int G, int ps, int n_table, int window,
                    float qscale, int stages) {
  using Geom = DecodeGeom<T, PT, HD>;
  constexpr bool MMA = Geom::MMA, QUANT = Geom::QUANT;
  constexpr int ROWB = Geom::ROWB, CPR = Geom::CPR, VEC = Geom::VEC;
  constexpr int TILE = Geom::TILE, STAGE = Geom::STAGE;
  constexpr int E = HD / 32;                  // scalar: output columns a lane
  constexpr int MT = HD / 16;                 // tensor cores: 16-column tiles

  const int nw = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = blockIdx.x;
  const int ngg = (G + PD_MAXG - 1) / PD_MAXG;
  const int h = blockIdx.y / ngg;
  const int g0 = (blockIdx.y % ngg) * PD_MAXG;
  const int gn = min(PD_MAXG, G - g0);        // heads of this G-group
  const int splits = gridDim.z, z = blockIdx.z;

  // the slot's live keys, and this split's pages [p0, p1) and keys [k0, k1)
  const int length = lengths[slot];
  const int cur = length - 1;                 // the newest token's position
  const int cells = window > 0 ? min(length, window) : length;
  const int key_end = max(0, min(cells, n_table * ps));
  const int n = (key_end + ps - 1) / ps;
  const int p0 = z * n / splits, p1 = (z + 1) * n / splits;
  const int k0 = p0 * ps, k1 = min(p1 * ps, key_end);
  const int rounds = k1 > k0 ? (k1 - k0 + PD_KEYS - 1) / PD_KEYS : 0;

  // shared memory: [nw][stages] stages | [nw] scratch | [PD_MAXG][HD] Q
  // (scalar body) | the split's table entries
  extern __shared__ __align__(16) unsigned char smem[];
  const int body = max(nw * stages * STAGE, nw * PD_MAXG * (HD + 2) * 4);
  unsigned char* my_stages = smem + w * stages * STAGE;
  unsigned char* scratch = smem + body + w * Geom::SCRATCH;
  float* P = reinterpret_cast<float*>(scratch);
  float* qs = reinterpret_cast<float*>(smem + body + nw * Geom::SCRATCH);
  int* tbl = reinterpret_cast<int*>(qs + (MMA ? 0 : PD_MAXG * HD));

  // q [slots, KV, G, HD]; the scalar body's Q pre-scaled into log2 units
  const int64_t qrow = (static_cast<int64_t>(slot) * KV + h) * G + g0;
  if constexpr (!MMA)
    for (int i = threadIdx.x; i < PD_MAXG * HD; i += blockDim.x)
      qs[i] = i / HD < gn ? to_f32(q[qrow * HD + i]) * qscale : 0.f;
  const int* row = page_table + static_cast<int64_t>(slot) * n_table;
  for (int i = threadIdx.x; i < p1 - p0; i += blockDim.x) tbl[i] = row[p0 + i];
  __syncthreads();

  // this warp takes rounds w, w + nw, ...; round j of it in stage j % stages
  const int my_rounds = w < rounds ? (rounds - w + nw - 1) / nw : 0;
  auto issue = [&](int j) {
    if (j < my_rounds) {
      unsigned char* st = my_stages + (j % stages) * STAGE;
      const int kr = k0 + (w + j * nw) * PD_KEYS;
      // a lane copies chunks c0 + i * LPR of rows r0, r0 + RSTEP, ...; the
      // page and offset of its row advance without a division
      constexpr int LPR = CPR < 32 ? CPR : 32;
      constexpr int RSTEP = 32 / LPR;
      const int r0 = lane / LPR, c0 = lane % LPR;
      int pg = (kr + r0) / ps, off = kr + r0 - pg * ps;
      for (int r = r0; r < PD_KEYS; r += RSTEP) {
        const bool ok = kr + r < k1;
        int64_t src = 0;
        if (ok)
          src = ((static_cast<int64_t>(tbl[pg - p0]) * ps + off) * KV + h) *
                HD;
#pragma unroll
        for (int i = 0; i < CPR / LPR; ++i) {
          const int c = c0 + i * LPR;
          cp_async16(st + r * ROWB + ((c ^ Geom::ksw(r)) << 4),
                     k_pages + src + c * VEC, ok);
          cp_async16(st + TILE + r * ROWB + ((c ^ Geom::vsw(r)) << 4),
                     v_pages + src + c * VEC, ok);
        }
        for (off += RSTEP; off >= ps; off -= ps) ++pg;
      }
      if constexpr (QUANT) {
        // lane 2r: the word holding key r's K scale, lane 2r + 1 its V
        // scale (a scale's word is its element index rounded down to even;
        // the wrapper asks ps * KV even, so every word lies in the array)
        const int r = lane >> 1;
        const int idx = kr + r;
        const bool ok = idx < k1;
        const __nv_bfloat16* src = (lane & 1) ? v_scale : k_scale;
        if (ok) {
          const int pr = idx / ps;
          src += ((static_cast<int64_t>(tbl[pr - p0]) * ps + idx - pr * ps) *
                      KV + h) & ~static_cast<int64_t>(1);
        }
        cp_async4(st + 2 * TILE + (lane & 1) * PD_KEYS * 4 + r * 4, src, ok);
      }
    }
    cp_async_commit();                        // one group a round, even empty
  };
  // the bf16 scales of key r of a stage (int8 pages); which half of its
  // word is the parity of the scale's element index
  auto scales = [&](const unsigned char* st, int r, int idx, float& ks,
                    float& vs) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(st + 2 * TILE);
    const bool odd = (KV % 2 == 0 ? h : idx % ps + h) & 1;
    const uint32_t kw = words[r], vw = words[PD_KEYS + r];
    ks = __uint_as_float(odd ? kw & 0xffff0000u : kw << 16);
    vs = __uint_as_float(odd ? vw & 0xffff0000u : vw << 16);
  };
  auto live = [&](int idx) {
    return idx < k1 &&
           (window == 0 || cur - floormod(cur - idx, window) >= 0);
  };

  float* red = reinterpret_cast<float*>(smem);   // the warps' fold, below
  float* red_m = red + nw * PD_MAXG * HD;
  float* red_l = red_m + nw * PD_MAXG;

  for (int j = 0; j < stages - 1; ++j) issue(j);
  if constexpr (MMA) {
    // --- bf16 queries: mma.sync m16n8k16, keys as the M rows -------------
    // S^T (16 keys x 8 heads) = K (16 x HD) Q^T; O^T (HD x 8 heads) +=
    // V^T (HD x 16 keys) P^T.  gid = lane / 4 and tig = lane % 4: this
    // lane's scores are keys gid, gid + 8 of heads 2 tig, 2 tig + 1, and
    // its output columns 16 mt + gid (+ 8) of the same two heads.  The
    // head dims of a 16-wide k-step are taken in the order 0 1 8 9 -> 0 1
    // 2 3 (lane tig's four elements contiguous in memory, for K and Q
    // alike: a dot product does not depend on the order of its terms).
    const int gid = lane >> 2, tig = lane & 3;
    uint32_t qf[MT][2];                       // B fragments of Q^T
    {
      const int g = gid < gn ? gid : 0;
      const T* qg = q + (qrow + g) * HD;
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        const uint2 v = gid < gn
            ? *reinterpret_cast<const uint2*>(qg + 16 * kk + 4 * tig)
            : make_uint2(0u, 0u);
        qf[kk][0] = v.x;
        qf[kk][1] = v.y;
      }
    }
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    __nv_bfloat16* vwide = reinterpret_cast<__nv_bfloat16*>(
        scratch + Geom::P_FLOATS * 4);        // int8 pages: V as bf16

    for (int j = 0; j < my_rounds; ++j) {
      cp_async_wait_n(stages - 2);            // round j has landed
      __syncwarp();                           // ... for every lane; and
      issue(j + stages - 1);                  // round j - 1's stage is free
      const unsigned char* st = my_stages + (j % stages) * STAGE;
      const int kr = k0 + (w + j * nw) * PD_KEYS;

      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t a[4];                        // K rows gid, gid + 8
        if constexpr (QUANT) {
          const int c = kk;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
              st + gid * ROWB + ((c ^ Geom::ksw(gid)) << 4) + 4 * tig);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
              st + (gid + 8) * ROWB + ((c ^ Geom::ksw(gid + 8)) << 4) +
              4 * tig);
          int8x4_to_bf16(w0, a[0], a[2]);
          int8x4_to_bf16(w1, a[1], a[3]);
        } else {
          const int c = 2 * kk + (tig >> 1);
          const uint2 w0 = *reinterpret_cast<const uint2*>(
              st + gid * ROWB + ((c ^ Geom::ksw(gid)) << 4) + 8 * (tig & 1));
          const uint2 w1 = *reinterpret_cast<const uint2*>(
              st + (gid + 8) * ROWB + ((c ^ Geom::ksw(gid + 8)) << 4) +
              8 * (tig & 1));
          a[0] = w0.x;
          a[2] = w0.y;
          a[1] = w1.x;
          a[3] = w1.y;
        }
        mma_bf16(s, a, qf[kk][0], qf[kk][1]);
      }

      // scale into log2 units (int8: times each key's scale), mask, and
      // the online softmax of heads 2 tig, 2 tig + 1 over the 16 keys
      float vsc[2] = {1.f, 1.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int idx = kr + gid + 8 * hr;
        float ksc = 1.f;
        if constexpr (QUANT) scales(st, gid + 8 * hr, idx, ksc, vsc[hr]);
        const bool ok = live(idx);
        s[2 * hr] = ok ? s[2 * hr] * qscale * ksc : NEG_INF;
        s[2 * hr + 1] = ok ? s[2 * hr + 1] * qscale * ksc : NEG_INF;
      }
      float corr[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = fmaxf(s[c], s[c + 2]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[c], mx);
        const float base = m_new == NEG_INF ? 0.f : m_new;
        corr[c] = ex2(m[c] - base);
        m[c] = m_new;
        s[c] = ex2(s[c] - base);
        s[c + 2] = ex2(s[c + 2] - base);
        l[c] = l[c] * corr[c] + s[c] + s[c + 2];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][0] *= corr[0];
        acc[mt][1] *= corr[1];
        acc[mt][2] *= corr[0];
        acc[mt][3] *= corr[1];
      }
      // P^T through shared memory: [head][key], rows 24 floats apart
      P[(2 * tig) * 24 + gid] = s[0] * vsc[0];
      P[(2 * tig + 1) * 24 + gid] = s[1] * vsc[0];
      P[(2 * tig) * 24 + gid + 8] = s[2] * vsc[1];
      P[(2 * tig + 1) * 24 + gid + 8] = s[3] * vsc[1];
      if constexpr (QUANT) {
        // widen the int8 V tile to bf16, chunk c of row r at c ^ (r & 7)
        const unsigned char* vt = st + TILE;
        for (int i = lane; i < PD_KEYS * CPR; i += 32) {
          const int r = i / CPR, c = i % CPR;
          const uint4 raw = *reinterpret_cast<const uint4*>(vt + i * 16);
          uint4 lo, hi;
          int8x4_to_bf16(raw.x, lo.x, lo.y);
          int8x4_to_bf16(raw.y, lo.z, lo.w);
          int8x4_to_bf16(raw.z, hi.x, hi.y);
          int8x4_to_bf16(raw.w, hi.z, hi.w);
          uint4* dst = reinterpret_cast<uint4*>(vwide + r * HD);
          dst[(2 * c) ^ (r & 7)] = lo;
          dst[(2 * c + 1) ^ (r & 7)] = hi;
        }
      }
      __syncwarp();
      // B fragments of P^T (head gid, keys 2 tig.. and 2 tig + 8..), each
      // as hi + lo bf16: P to ~2^-18 of itself
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float2 p =
            *reinterpret_cast<const float2*>(P + gid * 24 + 2 * tig + 8 * b);
        const __nv_bfloat162 hv = __floats2bfloat162_rn(p.x, p.y);
        const float2 hf = __bfloat1622float2(hv);
        bh[b] = *reinterpret_cast<const uint32_t*>(&hv);
        bl[b] = pack_bf16(p.x - hf.x, p.y - hf.y);
      }
      // O^T += V^T P^T, 16 output columns at a time
      const unsigned char* vt =
          QUANT ? reinterpret_cast<const unsigned char*>(vwide) : st + TILE;
      constexpr int VROWB = HD * 2;           // bytes of a bf16 V row
      const int vr = ((lane >> 4) << 3) + (lane & 7);   // key of my address
      const int vc = (lane >> 3) & 1;                     // + chunk
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(
            a, vt + vr * VROWB + (((2 * mt + vc) ^ (vr & 7)) << 4));
        mma_bf16(acc[mt], a, bh[0], bh[1]);
        mma_bf16(acc[mt], a, bl[0], bl[1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                          // every warp is off its stages

    // fold the warps: [nw][PD_MAXG][HD] acc, then [nw][PD_MAXG] m and l
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float lt = l[c];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, o);
      const int g = 2 * tig + c;
      if (g < gn) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          red[(w * PD_MAXG + g) * HD + 16 * mt + gid] = acc[mt][c];
          red[(w * PD_MAXG + g) * HD + 16 * mt + gid + 8] = acc[mt][c + 2];
        }
        if (gid == 0) {
          red_m[w * PD_MAXG + g] = m[c];
          red_l[w * PD_MAXG + g] = lt;
        }
      }
    }
  } else {
    // --- fp32 queries: scalar fp32 FMAs -----------------------------------
    // lane (t, part) scores key t of the round against every head over
    // half the head dim; in P V each lane owns E output columns.
    const int t = lane >> 1, part = lane & 1;
    float m[PD_MAXG], l[PD_MAXG], acc[PD_MAXG][E];
#pragma unroll
    for (int g = 0; g < PD_MAXG; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
    for (int j = 0; j < my_rounds; ++j) {
      cp_async_wait_n(stages - 2);
      __syncwarp();
      issue(j + stages - 1);
      const unsigned char* st = my_stages + (j % stages) * STAGE;
      const int idx = k0 + (w + j * nw) * PD_KEYS + t;

      float s[PD_MAXG];
#pragma unroll
      for (int g = 0; g < PD_MAXG; ++g) s[g] = 0.f;
      const unsigned char* krow = st + t * ROWB;
#pragma unroll
      for (int jj = 0; jj < CPR / 2; ++jj) {
        const int c = part + 2 * jj;
        float kf[VEC];
        load_widen<PT, VEC>(
            reinterpret_cast<const PT*>(krow + ((c ^ Geom::ksw(t)) << 4)),
            kf);
#pragma unroll
        for (int g = 0; g < PD_MAXG; ++g) {
          if (g < gn) {
            const float4* qv =
                reinterpret_cast<const float4*>(qs + g * HD + c * VEC);
#pragma unroll
            for (int v = 0; v < VEC / 4; ++v) {
              const float4 x = qv[v];
              s[g] = fmaf(x.x, kf[4 * v], s[g]);
              s[g] = fmaf(x.y, kf[4 * v + 1], s[g]);
              s[g] = fmaf(x.z, kf[4 * v + 2], s[g]);
              s[g] = fmaf(x.w, kf[4 * v + 3], s[g]);
            }
          }
        }
      }
      float ksc = 1.f, vsc = 1.f;
      if constexpr (QUANT) scales(st, t, idx, ksc, vsc);
      const bool ok = live(idx);

      // online softmax over the round's 16 keys, per head
#pragma unroll
      for (int g = 0; g < PD_MAXG; ++g) {
        if (g < gn) {
          float sg = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 1);
          sg = ok ? sg * ksc : NEG_INF;
          float mx = sg;
#pragma unroll
          for (int o = 2; o < 32; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[g], mx);
          const float base = m_new == NEG_INF ? 0.f : m_new;
          const float corr = ex2(m[g] - base);
          const float p = ex2(sg - base);
          l[g] = l[g] * corr + p;             // this lane's key; the lanes
          m[g] = m_new;                       // of other keys hold theirs
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= corr;
          s[g] = p * vsc;
        }
      }
      if (part == 0) {
        float4* pw = reinterpret_cast<float4*>(P + t * PD_MAXG);
        pw[0] = make_float4(s[0], s[1], s[2], s[3]);
        pw[1] = make_float4(s[4], s[5], s[6], s[7]);
      }
      __syncwarp();

      // P V: this lane's E columns of every head
      const unsigned char* vt = st + TILE + lane * E * sizeof(PT);
#pragma unroll 4
      for (int r = 0; r < PD_KEYS; ++r) {
        float vf[E];
        load_widen<PT, E>(reinterpret_cast<const PT*>(vt + r * ROWB), vf);
        const float4 pa = reinterpret_cast<const float4*>(P + r * PD_MAXG)[0];
        const float4 pb = reinterpret_cast<const float4*>(P + r * PD_MAXG)[1];
        const float pr[PD_MAXG] = {pa.x, pa.y, pa.z, pa.w,
                                   pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < PD_MAXG; ++g)
          if (g < gn)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[g][e] = fmaf(pr[g], vf[e], acc[g][e]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                          // every warp is off its stages

    // fold the warps: [nw][PD_MAXG][HD] acc, then [nw][PD_MAXG] m and l
#pragma unroll
    for (int g = 0; g < PD_MAXG; ++g) {
      if (g < gn) {
        float lt = l[g];                      // one lane of each key pair
#pragma unroll
        for (int o = 2; o < 32; o <<= 1)
          lt += __shfl_xor_sync(0xffffffffu, lt, o);
#pragma unroll
        for (int e = 0; e < E; ++e)
          red[(w * PD_MAXG + g) * HD + lane * E + e] = acc[g][e];
        if (lane == 0) {
          red_m[w * PD_MAXG + g] = m[g];
          red_l[w * PD_MAXG + g] = lt;
        }
      }
    }
  }
  __syncthreads();

  // the block's (m, l, acc) of head g, column d; out, or a split's partial
  // in ws: rows ((slot * KV + h) * G + g) * splits + z of m, then l, then
  // acc (HD floats a row)
  const int64_t R = static_cast<int64_t>(gridDim.x) * KV * G * splits;
  const int64_t row0 = (static_cast<int64_t>(slot) * KV + h) * G + g0;
  for (int i = threadIdx.x; i < gn * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
    for (int v = 0; v < nw; ++v) M = fmaxf(M, red_m[v * PD_MAXG + g]);
    float L = 0.f, A = 0.f;
    for (int v = 0; v < nw; ++v) {
      const float wt = ex2(red_m[v * PD_MAXG + g] - M);
      L += wt * red_l[v * PD_MAXG + g];
      A += wt * red[(v * PD_MAXG + g) * HD + d];
    }
    if (splits == 1) {
      out[(row0 + g) * HD + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
    } else {
      const int64_t r = (row0 + g) * splits + z;
      if (d == 0) {
        ws[r] = M;
        ws[R + r] = L;
      }
      ws[2 * R + r * HD + d] = A;
    }
  }
  if (splits == 1) return;

  // the last split of (slot, kv-head, G-group) to finish merges them all
  __shared__ unsigned last;
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + static_cast<int64_t>(slot) * gridDim.y +
                      blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // per head: each split's weight exp(m_z - max m) and 1 / max(sum l, 1e-30)
  float* wt = red;                            // [gn][splits], then [gn]
  float* inv = wt + gn * splits;
  if (threadIdx.x < gn) {
    const int64_t r = (row0 + threadIdx.x) * splits;
    float M = NEG_INF;
    for (int v = 0; v < splits; ++v) M = fmaxf(M, __ldcg(ws + r + v));
    float L = 0.f;
    for (int v = 0; v < splits; ++v) {
      const float x = ex2(__ldcg(ws + r + v) - M);
      wt[threadIdx.x * splits + v] = x;
      L += x * __ldcg(ws + R + r + v);
    }
    inv[threadIdx.x] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    const int64_t r = (row0 + g) * splits;
    float A = 0.f;
    for (int v = 0; v < splits; ++v)
      A += wt[g * splits + v] * __ldcg(ws + 2 * R + (r + v) * HD + d);
    out[(row0 + g) * HD + d] = from_f32<T>(A * inv[g]);
  }
  if (threadIdx.x == 0) *counter = 0;         // ready for the next launch
}

template <typename T, typename PT, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* lengths, void* out, void* ws, void* counters,
           int slots, int KV, int G, int ps, int n_table, int window,
           int splits, cudaStream_t stream) {
  using Geom = DecodeGeom<T, PT, HD>;
  int warps, stages;
  Geom::pick(warps, stages);
  const size_t body = std::max(
      static_cast<size_t>(warps) * stages * Geom::STAGE,
      static_cast<size_t>(warps) * PD_MAXG * (HD + 2) * sizeof(float));
  const size_t smem =
      body + static_cast<size_t>(warps) * Geom::SCRATCH +
      (Geom::MMA ? 0 : PD_MAXG * HD * sizeof(float)) +
      ((n_table + splits - 1) / splits + 1) * sizeof(int);
  auto kernel = paged_decode_kernel<T, PT, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ngg = (G + PD_MAXG - 1) / PD_MAXG;
  kernel<<<dim3(slots, KV * ngg, splits), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<unsigned*>(counters), KV, G, ps, n_table, window,
      LOG2E / sqrtf(static_cast<float>(HD)), stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename PT>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* table,
              const void* lengths, void* out, void* ws, void* counters,
              int slots, int KV, int G, int ps, int n_table, int window,
              int splits, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, PT, 64>(q, k, v, ks, vs, table, lengths, out, ws,
                               counters, slots, KV, G, ps, n_table, window,
                               splits, stream);
    case 128:
      return launch<T, PT, 128>(q, k, v, ks, vs, table, lengths, out, ws,
                                counters, slots, KV, G, ps, n_table, window,
                                splits, stream);
    case 256:
      return launch<T, PT, 256>(q, k, v, ks, vs, table, lengths, out, ws,
                                counters, slots, KV, G, ps, n_table, window,
                                splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_pages(int quantized, int hd, const void* q, const void* k,
                 const void* v, const void* ks, const void* vs,
                 const void* table, const void* lengths, void* out, void* ws,
                 void* counters, int slots, int KV, int G, int ps,
                 int n_table, int window, int splits, cudaStream_t stream) {
  if (quantized)
    return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, table, lengths, out, ws,
                                counters, slots, KV, G, ps, n_table, window,
                                splits, stream);
  return launch_hd<T, T>(hd, q, k, v, ks, vs, table, lengths, out, ws,
                         counters, slots, KV, G, ps, n_table, window, splits,
                         stream);
}

}  // namespace repro_torch

// q [slots, KV, G, hd]; k/v_pages [P, ps, KV, hd] in q's dtype, or int8
// with k/v_scale [P, ps, KV] bf16 (quantized = 1, ps * KV even; null
// pointers otherwise); page_table [slots, n_table] int32; lengths [slots]
// int32; window 0 (contiguous) or the ring's window; out [slots, KV, G,
// hd].  splits > 1 splits every slot's live pages over blockIdx.z, with ws
// the fp32 workspace of slots x KV x G x splits x (hd + 2) floats and
// counters slots x KV x ceil(G / 8) unsigned ints, zero before the launch
// and left zero by it (null for splits = 1).  Returns the cudaError_t of
// the launch (0 = queued).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* k_scale,
                                      const void* v_scale,
                                      const void* page_table,
                                      const void* lengths, void* out,
                                      void* ws, void* counters, int slots,
                                      int KV, int G, int hd, int ps,
                                      int n_table, int window, int dtype,
                                      int quantized, int splits,
                                      void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > 32 || window < 0 || ps < 1 || splits < 1 ||
      splits > PD_MAX_SPLITS ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr ||
                     (ps * KV) % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_pages<__nv_bfloat16>(quantized, hd, q, k_pages, v_pages,
                                       k_scale, v_scale, page_table, lengths,
                                       out, ws, counters, slots, KV, G, ps,
                                       n_table, window, splits, s);
  if (dtype == DTYPE_F32)
    return launch_pages<float>(quantized, hd, q, k_pages, v_pages, k_scale,
                               v_scale, page_table, lengths, out, ws,
                               counters, slots, KV, G, ps, n_table, window,
                               splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
