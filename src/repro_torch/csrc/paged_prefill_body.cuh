// The bf16 tensor-core body of the paged chunked-prefill kernels for Hopper
// (sm_90a): K2 on contiguous pages (paged_prefill.cu) and K5 on ring
// pages (paged_ring_prefill.cu), with their int8-page (K8) branches.  The
// two differ only in how a key position maps to a row, which the template
// parameter RING selects:
//   * contiguous (RING = false, K2): the pages already hold the chunk's
//     keys, position p is row p % ps of page page_row[p / ps], and a row
//     keeps the positions p <= qpos (the written bound start + n_valid
//     follows, since qpos < start + n_valid for every valid row);
//   * ring (RING = true, K5): positions below start are the ring snapshot
//     (cell p % window, kept if that cell is in the table and p is within
//     the window of the row), positions at or past start the chunk's own
//     keys from chunk_k / chunk_v (in q's dtype even for int8 pages).
//
//  * Rows.  One kv-head's query rows flatten as r = i * G + g (the TPU
//    kernels' (qb * G, hd) scratch); a block takes one kv-head and a
//    64-row tile of them, one warpgroup of 4 warps x 16 rows (the wgmma's
//    M), so a tile may straddle queries and each row carries its own
//    qpos = start + r / G.  Rows at or past n_valid * G are padding.
//  * Keys by position.  The block walks absolute positions [lo, hi): hi is
//    one past its last valid row's position, lo is 0 (contiguous) or the
//    first row's window edge (ring).  The walk covers exactly the keys some
//    row of the block keeps, with no dead tile, and only the tiles on the
//    causal diagonal (and for the ring at the window edge and in a ring
//    shorter than the window) are masked, on the fp32 score fragment before
//    the row max.  Nothing at or past hi is read: the table's 0-padded tail
//    names the trash page.  K / V tiles of 64 positions are gathered row by
//    row by cp.async into 128-byte-swizzled shared memory, double-buffered;
//    the next tile's gather is issued while the tensor cores take this
//    tile's Q K^T.  Q K^T is wgmma with Q and K in shared memory; P V takes
//    P from registers as hi + lo bf16 operands (~2^-18 of P) and V
//    transposed from shared memory (attn_tiles.cuh, as K3).
//  * int8 pages (K8).  Page rows land int8 in a staging buffer and widen to
//    bf16 in the tile (exact: |x| <= 127; byte permutes and one fp32 add a
//    value, while the tensor cores take P V); each key's scale multiplies
//    its score column after the softmax scale and before the mask, each
//    value's scale the probability column before P is split for P V, and
//    the denominator sums the unscaled probabilities.
//  * Split over keys.  When KV x row tiles leaves the card short of work (a
//    verify: 8 blocks on 132 SMs), the wrapper picks `splits` and
//    blockIdx.z takes a contiguous range of the block's key tiles, writing
//    fp32 partials (m, l, acc) to a workspace; prefill_merge_kernel
//    rescales them by their max, divides by max(sum l, 1e-30) and writes
//    the output, zero rows included (merge_partials_ref is its plain
//    version).  A split whose rows saw no live key leaves m = NEG_INF,
//    l = 0, acc = 0, which the merge weighs out (or, for a row that never
//    sees a live key, turns into 0).
#pragma once

#include <limits.h>

#include "attn_tiles.cuh"

namespace repro_torch {

constexpr int RP_BM = 64;                   // query rows per block
constexpr int RP_BK = 64;                   // key positions per tile
constexpr int RP_THREADS = 128;             // 4 warps x 16 rows

// rows [r0, r0 + RP_BM) of one kv-head: the key positions they keep,
// [lo, hi), and so the number of key tiles (the wrapper's
// ``prefill_key_tiles`` mirrors this); window 0 is contiguous pages
struct PrefillKeys {
  int lo, hi, tiles;
  __device__ PrefillKeys(int r0, int G, int start, int n_valid, int window) {
    const int r_hi = min(r0 + RP_BM, n_valid * G);
    lo = window > 0 ? max(0, start + r0 / G - window + 1) : 0;
    hi = start + (r_hi - 1) / G + 1;
    tiles = (hi - lo + RP_BK - 1) / RP_BK;
  }
};

// q / out [S, KV, G, HD] bf16; k/v_pages [P, ps, KV, HD] bf16 or int8
// (PT), k/v_scale [P, ps, KV] bf16 (int8 pages); chunk_k / chunk_v
// [S, KV, HD] bf16 (ring only); page_row: the request's n_cells / ps
// pages; ws the split partials (splits > 1).
template <bool RING, typename PT, int HD>
__global__ void __launch_bounds__(RP_THREADS)
paged_prefill_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ chunk_k,
    const __nv_bfloat16* __restrict__ chunk_v,
    const int* __restrict__ page_row, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int S, int KV, int G, int ps, int n_cells,
    int start, int n_valid, int window, float scale_log2, int splits,
    int rows_pad) {
  constexpr bool QUANT = sizeof(PT) == 1;
  constexpr int NT = RP_BK / 8;              // 8-key score tiles
  constexpr int NO = HD / 8;                 // 8-column output tiles
  constexpr int QE = RP_BM * HD;             // elements of the Q tile
  constexpr int KE = RP_BK * HD;             // elements of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles, 1024-byte aligned: Q, then [stage][K | V]
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  __nv_bfloat16* tiles = q_tile + QE;
  float* k_sc = reinterpret_cast<float*>(tiles + 4 * KE);     // [2][BK]
  float* v_sc = k_sc + 2 * RP_BK;                              // [2][BK]
  // [k|v][BK][HD] int8 page rows of the tile in flight (int8 pages)
  int8_t* staging = reinterpret_cast<int8_t*>(v_sc + 2 * RP_BK);

  const int h = blockIdx.x;
  const int r0 = blockIdx.y * RP_BM;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = S * G, rows_valid = n_valid * G;
  const bool split = splits > 1;
  // positions at or past this come from the chunk operands (ring only)
  const int chunk_from = RING ? start : INT_MAX;

  auto out_off = [&](int r) {               // out/q [S, KV, G, HD]
    const int i = r / G;
    return ((static_cast<int64_t>(i) * KV + h) * G + (r - i * G)) * HD;
  };

  if (r0 >= rows_valid) {                   // all padding: touch no key
    if (split) return;                      // the merge writes the zeros
    constexpr int CPR = HD / 8;
    const int n = min(RP_BM, rows - r0) * CPR;
    for (int i = tid; i < n; i += RP_THREADS)
      *reinterpret_cast<uint4*>(out + out_off(r0 + i / CPR) + (i % CPR) * 8) =
          make_uint4(0, 0, 0, 0);
    return;
  }

  const PrefillKeys keys(r0, G, start, n_valid, RING ? window : 0);
  const int t_begin = static_cast<int>(static_cast<int64_t>(z) * keys.tiles /
                                       splits);
  const int t_end = static_cast<int>(static_cast<int64_t>(z + 1) *
                                     keys.tiles / splits);
  const int qpos_first = start + r0 / G;
  const int qpos_last = start + (min(r0 + RP_BM, rows_valid) - 1) / G;
  const bool short_ring = RING && n_cells < window;

  // this thread's two rows: gid and gid + 8 of its warp's 16
  const int ra = r0 + warp * 16 + lane / 4;
  const int qpos[2] = {start + ra / G, start + (ra + 8) / G};

  // element offset of the page row of cell idx (< n_cells): page
  // page_row[idx / ps], offset idx % ps (a shift for the usual power-of-two
  // page)
  const bool ps_pow2 = (ps & (ps - 1)) == 0;
  const int ps_shift = __ffs(ps) - 1;
  auto cell_row = [&](int idx) -> int64_t {
    const int pi = ps_pow2 ? idx >> ps_shift : idx / ps;
    const int page = __ldg(page_row + pi);
    return ((static_cast<int64_t>(page) * ps + (idx - pi * ps)) * KV + h) *
           HD;
  };
  // the cell of position a + row, a's cell being idx0: on the ring
  // idx0 = a % window, contiguous pages idx0 = a
  auto cell_of = [&](int idx0, int row) {
    const int idx = idx0 + row;
    if (!RING) return idx;
    return idx < window ? idx : idx % window;
  };

  // int8 page rows: this thread copies (and later widens) the 16-byte
  // chunks i = tid + k * RP_THREADS, k < NCH8, of a tile: rows
  // tid / CPR8 + k * (RP_THREADS / CPR8), column (tid % CPR8) * 16
  constexpr int CPR8 = HD / 16;
  constexpr int NCH8 = RP_BK * CPR8 / RP_THREADS;
  static_assert(NCH8 * RP_THREADS == RP_BK * CPR8, "whole chunks a thread");
  const int row8 = tid / CPR8, col8 = (tid % CPR8) * 16;

  // What issue_tile hands to the end of the iteration (int8 pages): this
  // thread's scale of the tile (k for threads < BK, v above; 1 for chunk
  // rows) and, bit k of `paged` / `member`, whether its chunk k is a page
  // row / a page row whose cell is in the table.
  struct Issued {
    float sc = 1.f;
    uint32_t paged = 0, member = 0;
  };

  // issue the copies of key tile t into stage st
  auto issue_tile = [&](int t, int st) {
    const int a = keys.lo + t * RP_BK;
    const int idx0 = RING ? a % window : a;
    __nv_bfloat16* kd = tiles + 2 * st * KE;
    __nv_bfloat16* vd = kd + KE;
    constexpr int CPR = HD / 8;
    constexpr int NCH = RP_BK * CPR / RP_THREADS;   // chunks a thread
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int i = tid + k * RP_THREADS;
      const int row = i / CPR, j = i % CPR, c = j * 8;
      const int p = a + row;
      const __nv_bfloat16* ks = nullptr;
      const __nv_bfloat16* vs = nullptr;
      if (p < keys.hi) {
        if (p >= chunk_from) {
          const int64_t off = (static_cast<int64_t>(p - start) * KV + h) * HD;
          ks = chunk_k + off;
          vs = chunk_v + off;
        } else if (QUANT) {
          continue;                         // widened from the staging
        } else {
          const int idx = cell_of(idx0, row);
          if (idx < n_cells) {
            const int64_t off = cell_row(idx);
            ks = reinterpret_cast<const __nv_bfloat16*>(k_pages) + off;
            vs = reinterpret_cast<const __nv_bfloat16*>(v_pages) + off;
          }
        }
      }
      const int at = sw128_offset(RP_BK, row, j);
      cp_async16(kd + at, ks ? ks + c : q, ks != nullptr);
      cp_async16(vd + at, vs ? vs + c : q, vs != nullptr);
    }
    Issued out;
    if (QUANT) {
      int8_t* sk = staging;
      int8_t* sv = sk + RP_BK * HD;
#pragma unroll
      for (int k = 0; k < NCH8; ++k) {
        const int row = row8 + k * (RP_THREADS / CPR8);
        const int p = a + row;
        if (p >= chunk_from || p >= keys.hi) continue;
        out.paged |= 1u << k;
        const int idx = cell_of(idx0, row);
        if (idx >= n_cells) continue;
        out.member |= 1u << k;
        const int64_t off = cell_row(idx);
        cp_async16(sk + row * HD + col8, k_pages + off + col8, true);
        cp_async16(sv + row * HD + col8, v_pages + off + col8, true);
      }
      const int row = tid % RP_BK;
      const int p = a + row;
      if (p < chunk_from && p < keys.hi) {
        const int idx = cell_of(idx0, row);
        if (idx < n_cells)
          out.sc = __bfloat162float(
              (tid < RP_BK ? k_scale : v_scale)[cell_row(idx) / HD]);
      }
    }
    return out;
  };

  // int8 pages: widen the tile's page rows from the staging into stage st
  // (cells missing from the table become zero rows).  Each thread widens
  // the very chunks it copied, so its own wait_group makes them visible
  // and no barrier is needed before it; the barrier that follows (at the
  // top of the next iteration) precedes the next tile's copies into the
  // staging, so one staging buffer serves every tile.
  auto widen_tile = [&](const Issued& is, int st) {
    const int8_t* sk = staging;
#pragma unroll
    for (int k = 0; k < NCH8; ++k) {
      if (!(is.paged >> k & 1)) continue;
      const int row = row8 + k * (RP_THREADS / CPR8);
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (is.member >> k & 1)
          raw = *reinterpret_cast<const uint4*>(sk + kv * RP_BK * HD +
                                                row * HD + col8);
        uint4 w0, w1;
        int8x4_to_bf16(raw.x, w0.x, w0.y);
        int8x4_to_bf16(raw.y, w0.z, w0.w);
        int8x4_to_bf16(raw.z, w1.x, w1.y);
        int8x4_to_bf16(raw.w, w1.z, w1.w);
        __nv_bfloat16* dst = tiles + (2 * st + kv) * KE;
        *reinterpret_cast<uint4*>(dst + sw128_offset(RP_BK, row, col8 / 8)) =
            w0;
        *reinterpret_cast<uint4*>(
            dst + sw128_offset(RP_BK, row, col8 / 8 + 1)) = w1;
      }
    }
  };

  float o[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // prologue: Q (rows past n_valid * G zero) and the first key tile
  cp_async_rows_sw128<HD, RP_THREADS>(
      q_tile, RP_BM, q, [&](int t) -> const __nv_bfloat16* {
        const int r = r0 + t;
        return r < rows_valid ? q + out_off(r) : nullptr;
      });
  Issued next;
  if (t_begin < t_end) next = issue_tile(t_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  if (QUANT && t_begin < t_end) {
    (tid < RP_BK ? k_sc : v_sc)[tid % RP_BK] = next.sc;
    widen_tile(next, 0);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t > t_begin) cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();                        // tile t landed; t - 1 consumed

    const __nv_bfloat16* kd = tiles + 2 * st * KE;
    const __nv_bfloat16* vd = kd + KE;
    const float* ksc = k_sc + st * RP_BK;
    const float* vsc = v_sc + st * RP_BK;
    // S = Q K^T on the warpgroup: HD / 16 k-steps of 32 bytes into a
    // 64-column block of Q and of K, both in shared memory
    float s[NT][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(s,
               sw128_desc(q_tile + (ks >> 2) * RP_BM * 64 + (ks & 3) * 16, 0,
                          1024),
               sw128_desc(kd + (ks >> 2) * RP_BK * 64 + (ks & 3) * 16, 0,
                          1024),
               ks > 0);
    wgmma_commit();
    // while the tensor cores take it: the next tile's gathered copies
    if (t + 1 < t_end) next = issue_tile(t + 1, st ^ 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int a = keys.lo + t * RP_BK;
    const bool masked =
        a + RP_BK - 1 > qpos_first ||
        (RING && (a <= qpos_last - window || (short_ring && a < start)));
    // scores in log2 units: softmax scale x log2(e), times the key's scale
    // (int8), then the masks
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      float2 f = make_float2(scale_log2, scale_log2);
      if (QUANT) {
        const float2 k2 = *reinterpret_cast<const float2*>(ksc + col);
        f = make_float2(f.x * k2.x, f.y * k2.y);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * ((e & 1) ? f.y : f.x);
        if (masked) {
          const int p = a + col + (e & 1);
          const int qp = qpos[e >> 1];
          const bool live =
              p <= qp && (!RING || (p > qp - window &&
                                    (p >= start || p % window < n_cells)));
          x = live ? x : NEG_INF;
        }
        s[j][e] = x;
      }
    }
    float corr[2];
    softmax_p<NT>(s, m, l, corr);
    rescale_o<NO>(o, corr);
    if (QUANT) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(vsc + j * 8 + (lane % 4) * 2);
        s[j][0] *= v2.x;
        s[j][1] *= v2.y;
        s[j][2] *= v2.x;
        s[j][3] *= v2.y;
      }
    }
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
      const uint64_t dv = sw128_desc(vd + kk * 16 * 64, RP_BK * 128, 1024);
      wgmma_rt(o, hi[kk], dv, 1);
      wgmma_rt(o, lo[kk], dv, 1);
    }
    wgmma_commit();
    if (QUANT && t + 1 < t_end) {           // tile t + 1's scales and rows,
      (tid < RP_BK ? k_sc : v_sc)[(st ^ 1) * RP_BK + tid % RP_BK] = next.sc;
      cp_async_wait<0>();                   // widened while P V runs
      widen_tile(next, st ^ 1);
    }
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
  }

  const int col0 = (lane % 4) * 2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = ra + 8 * hr;
    const float lr = quad_sum(l[hr]);
    if (split) {
      if (r >= rows_valid) continue;
      const int64_t at = (static_cast<int64_t>(z) * KV + h) * rows_pad + r;
      const int64_t per = static_cast<int64_t>(splits) * KV * rows_pad;
      if (lane % 4 == 0) {
        ws[at] = m[hr] == NEG_INF ? NEG_INF : m[hr] * LN2;   // natural units
        ws[per + at] = lr;
      }
      float* acc = ws + 2 * per + at * HD + col0;
#pragma unroll
      for (int c = 0; c < NO; ++c)
        *reinterpret_cast<float2*>(acc + c * 8) =
            make_float2(o[c][2 * hr], o[c][2 * hr + 1]);
      continue;
    }
    if (r >= rows) continue;
    const float inv = r < rows_valid ? 1.f / fmaxf(lr, 1e-30f) : 0.f;
    __nv_bfloat16* dst = out + out_off(r) + col0;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<uint32_t*>(dst + c * 8) =
          pack_bf16(o[c][2 * hr] * inv, o[c][2 * hr + 1] * inv);
  }
}

// Merge the splits' partials of every row: out = sum_z e^(m_z - M) acc_z /
// max(sum_z e^(m_z - M) l_z, 1e-30) with M = max_z m_z; rows at or past
// n_valid * G are 0.  One warp per row, HD / 32 columns a lane.
constexpr int RP_MERGE_ROWS = 8;            // warps (rows) per block

template <int HD>
__global__ void __launch_bounds__(RP_MERGE_ROWS * 32)
prefill_merge_kernel(const float* __restrict__ ws,
                     __nv_bfloat16* __restrict__ out, int S, int KV, int G,
                     int n_valid, int splits, int rows_pad) {
  constexpr int E = HD / 32;
  const int h = blockIdx.x;
  const int r = blockIdx.y * RP_MERGE_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= S * G) return;
  const int i = r / G;
  __nv_bfloat16* dst =
      out + ((static_cast<int64_t>(i) * KV + h) * G + (r - i * G)) * HD +
      lane * E;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float lsum = 0.f;
  if (r < n_valid * G) {
    const int64_t per = static_cast<int64_t>(splits) * KV * rows_pad;
    const int64_t row = static_cast<int64_t>(h) * rows_pad + r;
    const int64_t zs = static_cast<int64_t>(KV) * rows_pad;
    float mx = NEG_INF;
    for (int z = 0; z < splits; ++z) mx = fmaxf(mx, ws[z * zs + row]);
    for (int z = 0; z < splits; ++z) {
      const float w = expf(ws[z * zs + row] - mx);
      lsum += w * ws[per + z * zs + row];
      const float* a = ws + 2 * per + (z * zs + row) * HD + lane * E;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += w * a[e];
    }
    lsum = 1.f / fmaxf(lsum, 1e-30f);
  }
#pragma unroll
  for (int e = 0; e < E; e += 2)
    *reinterpret_cast<uint32_t*>(dst + e) =
        pack_bf16(acc[e] * lsum, acc[e + 1] * lsum);
}

// Launch the bf16 body (and, for splits > 1, the merge) on `stream`;
// n_cells is the table's cells (n_table * ps).  Returns the cudaError_t.
template <bool RING, typename PT, int HD>
int launch_prefill_wgmma(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const void* chunk_k,
                         const void* chunk_v, const void* page_row,
                         void* out, void* ws, int S, int KV, int G, int ps,
                         int n_cells, int start, int n_valid, int window,
                         int splits, cudaStream_t stream) {
  constexpr bool QUANT = sizeof(PT) == 1;
  // Q, the K / V stages, up to 1 KB to align them, int8 scales and staging
  const size_t smem =
      (static_cast<size_t>(RP_BM) + 4 * RP_BK) * HD * 2 + 1024 +
      (QUANT ? 4 * RP_BK * sizeof(float) + 2 * static_cast<size_t>(RP_BK) * HD
             : 0);
  auto kernel = paged_prefill_wgmma_kernel<RING, PT, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int row_tiles = (S * G + RP_BM - 1) / RP_BM;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3(KV, row_tiles, splits), RP_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const bf16*>(k_scale),
      static_cast<const bf16*>(v_scale), static_cast<const bf16*>(chunk_k),
      static_cast<const bf16*>(chunk_v), static_cast<const int*>(page_row),
      static_cast<bf16*>(out), static_cast<float*>(ws), S, KV, G, ps,
      n_cells, start, n_valid, window,
      LOG2E / sqrtf(static_cast<float>(HD)), splits, row_tiles * RP_BM);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  prefill_merge_kernel<HD>
      <<<dim3(KV, (S * G + RP_MERGE_ROWS - 1) / RP_MERGE_ROWS),
         RP_MERGE_ROWS * 32, 0, stream>>>(
          static_cast<const float*>(ws), static_cast<bf16*>(out), S, KV, G,
          n_valid, splits, row_tiles * RP_BM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
