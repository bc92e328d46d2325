// Paged ring-window chunked-prefill attention for Hopper (sm_90a), fp or
// int8 snapshot pages (K5, and its K8 branch).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// `paged_ring_prefill_kernel` / `_paged_ring_prefill_kernel`: one
// request's bucketed chunk of S queries (query i at absolute position
// qpos = start + i) of a sliding-window family, with snapshot-before-write
// semantics.  The chunk's writes wrap onto ring cells its own early
// queries still need, so the kernel reads the ring as it was BEFORE the
// chunk's writes and takes the chunk's own keys / values as separate
// operands.  Two phases fold into one online softmax:
//   1. the ring snapshot: cells idx < min(start, window) of the request's
//      ring of n_table cells, each at position
//      kpos = cur - floormod(cur - idx, window) with cur = start - 1, kept
//      where kpos >= 0 (written) and kpos > qpos - window (in the window;
//      the snapshot precedes the chunk, so causality holds by itself);
//   2. the chunk's own keys chunk_k / chunk_v [S, KV, hd] (in q's dtype),
//      key j at kpos = start + j, kept where j < n_valid, kpos <= qpos and
//      kpos > qpos - window.
// Queries at or past n_valid write 0, and a block of padding queries
// touches no key.  int8 snapshot pages (K8) carry one bf16 scale per
// (page, offset, kv-head) row: raw scores times the key scale before the
// mask, probabilities times the value scale before the PV product, the
// denominator unscaled; the chunk operands are fp (scale 1).  Masked
// scores take the finite NEG_INF; the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  A 1024-query chunk that wraps
// mixtral's 4096-token ring (KV 8, G 6, hd 128) keeps ~25 M (query head,
// key) pairs, ~100 GFLOP: 0.10 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 16 MB of ring pages (5 us at 3.35 TB/s).  A verify row
// (S = 5) is the opposite: 30 query rows per kv-head against the whole
// ring, bound by the 16 MB of bytes, and only 8 (kv-head) units of work.
//
// The bf16 design (paged_ring_prefill_kernel_wgmma):
//  * Rows.  One kv-head's query rows flatten as r = i * G + g (the TPU
//    kernel's (qb * G, hd) scratch); a block takes one kv-head and a
//    64-row tile of them, one warpgroup of 4 warps x 16 rows (the wgmma's
//    M), so a tile may straddle queries and each row carries its own
//    qpos = start + r / G.  Rows at or past n_valid * G are padding.
//  * Keys by position.  A ring cell's position is congruent to its index
//    modulo the window, so the block walks absolute positions
//    [max(0, qpos_first - window + 1), qpos_last + 1): a position below
//    start is the ring row of cell p % window (kept if that cell is in the
//    table), one at or past start is chunk row p - start.  The walk covers
//    exactly the keys some row of the block keeps, with no dead tile, and
//    only the tiles at the window edge, the causal diagonal and a ring
//    shorter than the window are masked (on the fp32 score fragment,
//    before the row max).  K / V tiles of 64 positions are gathered row by
//    row by cp.async into 128-byte-swizzled shared memory, double-buffered;
//    the next tile's gather is issued while the tensor cores take this
//    tile's Q K^T.  Q K^T is wgmma with Q and K in shared memory; P V takes
//    P from registers as hi + lo bf16 operands (~2^-18 of P) and V
//    transposed from shared memory (attn_tiles.cuh, as K3).
//  * int8 snapshot pages (K8).  Ring rows land int8 in a staging buffer
//    and widen to bf16 in the tile (exact: |x| <= 127; byte permutes and
//    one fp32 add a value, while the tensor cores take P V); each key's
//    scale multiplies its score column after the softmax scale and before
//    the mask, each value's scale the probability column before P is
//    split for P V, and the denominator sums the unscaled probabilities.
//  * Split over keys.  When KV x row tiles leaves the card short of work
//    (a verify: 8 blocks on 132 SMs), the wrapper picks `splits` and
//    blockIdx.z takes a contiguous range of the block's key tiles, writing
//    fp32 partials (m, l, acc) to a workspace; paged_ring_prefill_kernel_
//    merge rescales them by their max, divides by max(sum l, 1e-30) and
//    writes the output, zero rows included.  A split whose rows saw no
//    live key leaves m = NEG_INF, l = 0, acc = 0, which the merge weighs
//    out (or, for a row that never sees a live key, turns into 0).
//
// fp32 (paged_ring_prefill_kernel<float, ...>) keeps the scalar body of
// the first port — one block per (kv-head, 8 queries), one warp per query
// over page tiles in shared memory — chosen by dtype alone.  It is what the
// fp32 arms run, holding teacher-forced logits within 1e-3 of the plain
// path; TF32 tensor cores (10-bit mantissa) would spend that margin.
#include "attn_tiles.cuh"

#include <type_traits>

namespace repro_torch {

// ---------------------------------------------------------------------------
// fp32 scalar kernel (the first port's body, unchanged)
// ---------------------------------------------------------------------------

constexpr int QB = 8;          // queries per block = warps per block
constexpr int MAXG = 8;        // largest GQA group the kernel holds

template <typename T, typename PT, int HD>
__global__ void paged_ring_prefill_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const T* __restrict__ chunk_k, const T* __restrict__ chunk_v,
    const int* __restrict__ page_row, T* __restrict__ out, int S, int KV,
    int G, int ps, int n_table, int start, int n_valid, int window,
    float scale) {
  constexpr int E = HD / 32;
  constexpr bool QUANT = sizeof(PT) == 1;
  extern __shared__ float smem[];
  float* k_tile = smem;                     // [ps, HD]
  float* v_tile = k_tile + ps * HD;         // [ps, HD]
  float* scores = v_tile + ps * HD;         // [QB, MAXG, ps]
  float* ks = scores + QB * MAXG * ps;      // [ps] (int8 snapshot pages)
  float* vs = ks + ps;                      // [ps]

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = q0 + w;                     // this warp's query
  float* sc = scores + w * MAXG * ps;

  // out/q [S, KV, G, HD]
  auto row_off = [&](int g) {
    return ((static_cast<int64_t>(i) * KV + h) * G + g) * HD;
  };

  if (q0 >= n_valid) {                      // all-padding block: emit 0
    if (i < S)
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[row_off(g) + lane * E + e] = from_f32<T>(0.f);
    return;
  }

  const bool active = i < n_valid;          // n_valid <= S
  const int qpos = start + i;
  const int cur = start - 1;                // newest snapshot position

  float qv[MAXG][E], acc[MAXG][E], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = (active && g < G) ? to_f32(q[row_off(g) + lane * E + e])
                                   : 0.f;
    }
  }

  // phase 1: the pre-write ring snapshot — its live cells hold positions
  // [max(0, start - window), start), exactly min(start, window) of them,
  // from cell 0 up
  const int cells = min(start, window);
  const int n_ring = min(n_table, (cells + ps - 1) / ps);
  // phase 2: chunk keys up to the block's last valid query
  const int keys = min(n_valid, q0 + QB);
  const int n_chunk = (keys + ps - 1) / ps;
  for (int p = 0; p < n_ring + n_chunk; ++p) {
    const bool ring = p < n_ring;
    const int base = ring ? p * ps : (p - n_ring) * ps;
    __syncthreads();                        // previous tile fully consumed
    if (ring) {
      const int page = page_row[p];
      load_tile<PT, HD>(k_tile, k_pages, page, ps, KV, h);
      load_tile<PT, HD>(v_tile, v_pages, page, ps, KV, h);
      if (QUANT) {
        load_scales(ks, k_scale, page, ps, KV, h);
        load_scales(vs, v_scale, page, ps, KV, h);
      }
    } else {
      const int64_t off = (static_cast<int64_t>(base) * KV + h) * HD;
      const int64_t stride = static_cast<int64_t>(KV) * HD;
      load_rows<T, HD>(k_tile, chunk_k + off, stride, ps, S - base);
      load_rows<T, HD>(v_tile, chunk_v + off, stride, ps, S - base);
    }
    __syncthreads();
    if (!active) continue;                  // padding query: loads only
    const bool scaled = QUANT && ring;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      for (int t = 0; t < ps; ++t) {
        float s = score<HD>(qv[g], k_tile, t, lane) * scale;
        if (scaled) s *= ks[t];
        bool live;
        if (ring) {
          const int kpos = cur - floormod(cur - (base + t), window);
          live = kpos >= 0 && kpos > qpos - window;
        } else {
          const int j = base + t;
          const int kpos = start + j;
          live = j < n_valid && kpos <= qpos && kpos > qpos - window;
        }
        if (lane == 0) sc[g * ps + t] = live ? s : NEG_INF;
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      online_update<HD>(m[g], l[g], acc[g], sc + g * ps, v_tile,
                        scaled ? vs : nullptr, ps, lane);
    }
    __syncwarp();                           // sc reused by the next tile
  }

  if (i >= S) return;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    const float inv = active ? 1.f / fmaxf(l[g], 1e-30f) : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[row_off(g) + lane * E + e] = from_f32<T>(acc[g][e] * inv);
  }
}


// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int RP_BM = 64;                   // query rows per block
constexpr int RP_BK = 64;                   // key positions per tile
constexpr int RP_THREADS = 128;             // 4 warps x 16 rows

// rows [r0, r0 + RP_BM) of one kv-head: the key positions they keep,
// [lo, hi), and so the number of key tiles (the wrapper's
// ``ring_prefill_key_tiles`` mirrors this)
struct RingKeys {
  int lo, hi, tiles;
  __device__ RingKeys(int r0, int G, int start, int n_valid, int window) {
    const int r_hi = min(r0 + RP_BM, n_valid * G);
    lo = max(0, start + r0 / G - window + 1);
    hi = start + (r_hi - 1) / G + 1;
    tiles = (hi - lo + RP_BK - 1) / RP_BK;
  }
};

template <typename PT, int HD>
__global__ void __launch_bounds__(RP_THREADS)
paged_ring_prefill_kernel_wgmma(
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
  // [k|v][BK][HD] int8 ring rows of the tile in flight (int8 pages)
  int8_t* staging = reinterpret_cast<int8_t*>(v_sc + 2 * RP_BK);

  const int h = blockIdx.x;
  const int r0 = blockIdx.y * RP_BM;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = S * G, rows_valid = n_valid * G;
  const bool split = splits > 1;

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

  const RingKeys keys(r0, G, start, n_valid, window);
  const int t_begin = static_cast<int>(static_cast<int64_t>(z) * keys.tiles /
                                       splits);
  const int t_end = static_cast<int>(static_cast<int64_t>(z + 1) *
                                     keys.tiles / splits);
  const int qpos_first = start + r0 / G;
  const int qpos_last = start + (min(r0 + RP_BM, rows_valid) - 1) / G;
  const bool short_ring = n_cells < window;

  // this thread's two rows: gid and gid + 8 of its warp's 16
  const int ra = r0 + warp * 16 + lane / 4;
  const int qpos[2] = {start + ra / G, start + (ra + 8) / G};

  // element offset of the ring row of cell idx (< n_cells): page
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
  // the ring cell of position a + row, a's cell being idx0 = a % window
  auto cell_of = [&](int idx0, int row) {
    const int idx = idx0 + row;
    return idx < window ? idx : idx % window;
  };

  // int8 ring rows: this thread copies (and later widens) the 16-byte
  // chunks i = tid + k * RP_THREADS, k < NCH8, of a tile: rows
  // tid / CPR8 + k * (RP_THREADS / CPR8), column (tid % CPR8) * 16
  constexpr int CPR8 = HD / 16;
  constexpr int NCH8 = RP_BK * CPR8 / RP_THREADS;
  static_assert(NCH8 * RP_THREADS == RP_BK * CPR8, "whole chunks a thread");
  const int row8 = tid / CPR8, col8 = (tid % CPR8) * 16;

  // What issue_tile hands to the end of the iteration (int8 pages): this
  // thread's scale of the tile (k for threads < BK, v above; 1 for chunk
  // rows) and, bit k of `ring` / `member`, whether its chunk k is a ring
  // row / a ring row whose cell is in the table.
  struct Issued {
    float sc = 1.f;
    uint32_t ring = 0, member = 0;
  };

  // issue the copies of key tile t into stage st
  auto issue_tile = [&](int t, int st) {
    const int a = keys.lo + t * RP_BK;
    const int idx0 = a % window;
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
        if (p >= start) {
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
      cp_async16(kd + at, ks ? ks + c : chunk_k, ks != nullptr);
      cp_async16(vd + at, vs ? vs + c : chunk_v, vs != nullptr);
    }
    Issued out;
    if (QUANT) {
      int8_t* sk = staging;
      int8_t* sv = sk + RP_BK * HD;
#pragma unroll
      for (int k = 0; k < NCH8; ++k) {
        const int row = row8 + k * (RP_THREADS / CPR8);
        const int p = a + row;
        if (p >= start || p >= keys.hi) continue;
        out.ring |= 1u << k;
        const int idx = cell_of(idx0, row);
        if (idx >= n_cells) continue;
        out.member |= 1u << k;
        const int64_t off = cell_row(idx);
        cp_async16(sk + row * HD + col8, k_pages + off + col8, true);
        cp_async16(sv + row * HD + col8, v_pages + off + col8, true);
      }
      const int row = tid % RP_BK;
      const int p = a + row;
      if (p < start && p < keys.hi) {
        const int idx = cell_of(idx0, row);
        if (idx < n_cells)
          out.sc = __bfloat162float(
              (tid < RP_BK ? k_scale : v_scale)[cell_row(idx) / HD]);
      }
    }
    return out;
  };

  // int8 pages: widen the tile's ring rows from the staging into stage st
  // (cells missing from the table become zero rows).  Each thread widens
  // the very chunks it copied, so its own wait_group makes them visible
  // and no barrier is needed before it; the barrier that follows (at the
  // top of the next iteration) precedes the next tile's copies into the
  // staging, so one staging buffer serves every tile.
  auto widen_tile = [&](const Issued& is, int st) {
    const int8_t* sk = staging;
#pragma unroll
    for (int k = 0; k < NCH8; ++k) {
      if (!(is.ring >> k & 1)) continue;
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
    const bool masked = a + RP_BK - 1 > qpos_first ||
                        a <= qpos_last - window ||
                        (short_ring && a < start);
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
          const bool live = p <= qp && p > qp - window &&
                            (p >= start || p % window < n_cells);
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
paged_ring_prefill_kernel_merge(const float* __restrict__ ws,
                                __nv_bfloat16* __restrict__ out, int S,
                                int KV, int G, int n_valid, int splits,
                                int rows_pad) {
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

template <typename PT, int HD>
int launch_mma(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scale, const void* v_scale, const void* chunk_k,
               const void* chunk_v, const void* page_row, void* out,
               void* ws, int S, int KV, int G, int ps, int n_table,
               int start, int n_valid, int window, int splits,
               cudaStream_t stream) {
  constexpr bool QUANT = sizeof(PT) == 1;
  // Q, the K / V stages, up to 1 KB to align them, int8 scales and staging
  const size_t smem =
      (static_cast<size_t>(RP_BM) + 4 * RP_BK) * HD * 2 + 1024 +
      (QUANT ? 4 * RP_BK * sizeof(float) + 2 * static_cast<size_t>(RP_BK) * HD
             : 0);
  auto kernel = paged_ring_prefill_kernel_wgmma<PT, HD>;
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
      n_table * ps, start, n_valid, window,
      LOG2E / sqrtf(static_cast<float>(HD)), splits, row_tiles * RP_BM);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  paged_ring_prefill_kernel_merge<HD>
      <<<dim3(KV, (S * G + RP_MERGE_ROWS - 1) / RP_MERGE_ROWS),
         RP_MERGE_ROWS * 32, 0, stream>>>(
          static_cast<const float*>(ws), static_cast<bf16*>(out), S, KV, G,
          n_valid, splits, row_tiles * RP_BM);
  return static_cast<int>(cudaGetLastError());
}


template <typename T, typename PT, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* chunk_k,
           const void* chunk_v, const void* page_row, void* out, int S,
           int KV, int G, int ps, int n_table, int start, int n_valid,
           int window, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(ps) * HD +
                       static_cast<size_t>(QB) * MAXG * ps + 2 * ps) *
                      sizeof(float);
  auto kernel = paged_ring_prefill_kernel<T, PT, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KV, (S + QB - 1) / QB);
  kernel<<<grid, QB * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const T*>(chunk_k), static_cast<const T*>(chunk_v),
      static_cast<const int*>(page_row), static_cast<T*>(out), S, KV, G, ps,
      n_table, start, n_valid, window, 1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (dtype, int8 pages, head dim): bf16 to the tensor-core
// kernel, fp32 to the scalar body
template <typename PT>
int launch_hd(int dtype, int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* ck, const void* cv,
              const void* row, void* out, void* ws, int S, int KV, int G,
              int ps, int n_table, int start, int n_valid, int window,
              int splits, cudaStream_t stream) {
  if (dtype == DTYPE_BF16) {
    if (hd == 64)
      return launch_mma<PT, 64>(q, k, v, ks, vs, ck, cv, row, out, ws, S, KV,
                                G, ps, n_table, start, n_valid, window,
                                splits, stream);
    if (hd == 128)
      return launch_mma<PT, 128>(q, k, v, ks, vs, ck, cv, row, out, ws, S,
                                 KV, G, ps, n_table, start, n_valid, window,
                                 splits, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  using FP = typename std::conditional<sizeof(PT) == 1, int8_t, float>::type;
  if (hd == 64)
    return launch<float, FP, 64>(q, k, v, ks, vs, ck, cv, row, out, S, KV, G,
                                 ps, n_table, start, n_valid, window, stream);
  if (hd == 128)
    return launch<float, FP, 128>(q, k, v, ks, vs, ck, cv, row, out, S, KV,
                                  G, ps, n_table, start, n_valid, window,
                                  stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

// q [S, KV, G, hd]; k/v_pages [P, ps, KV, hd] — the ring before the
// chunk's writes — in q's dtype, or int8 with k/v_scale [P, ps, KV] bf16
// (quantized = 1; null pointers otherwise); chunk_k / chunk_v [S, KV, hd]
// in q's dtype; page_row [n_table] int32, n_table * ps <= window;
// out [S, KV, G, hd].  bf16 only: `splits` > 1 splits every block's key
// tiles over blockIdx.z, with ws the fp32 workspace of splits x KV x
// rows_pad x (hd + 2) floats, rows_pad = 64 * ceil(S * G / 64) (null for
// splits = 1); fp32 takes splits = 1.  Returns the cudaError_t of the
// launches (0 = queued).
extern "C" int paged_ring_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* chunk_k,
    const void* chunk_v, const void* page_row, void* out, void* ws, int S,
    int KV, int G, int hd, int ps, int n_table, int start, int n_valid,
    int window, int dtype, int quantized, int splits, void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > MAXG || n_valid > S || S < 1 || window < 1 ||
      n_table * ps > window || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)) ||
      (dtype != DTYPE_BF16 && dtype != DTYPE_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch_hd<int8_t>(dtype, hd, q, k_pages, v_pages, k_scale,
                             v_scale, chunk_k, chunk_v, page_row, out, ws, S,
                             KV, G, ps, n_table, start, n_valid, window,
                             splits, s);
  return launch_hd<__nv_bfloat16>(dtype, hd, q, k_pages, v_pages, k_scale,
                                  v_scale, chunk_k, chunk_v, page_row, out,
                                  ws, S, KV, G, ps, n_table, start, n_valid,
                                  window, splits, s);
}
