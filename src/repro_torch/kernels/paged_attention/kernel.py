"""Wrappers of the hand-written CUDA paged-attention kernels.

  * ``paged_attention_kernel`` — K1 / K4, decode: ``csrc/paged_attention.cu``,
    the port of the TPU kernel ``paged_attention_kernel`` of the JAX
    package, contiguous pages (K1) and ring-wrapped window pages
    (``window > 0``, K4); every slot's live pages split over
    ``decode_splits`` blocks, merged in the same launch.
  * ``paged_prefill_kernel`` — K2, chunked prefill and speculative
    verify on contiguous pages: ``csrc/paged_prefill.cu``, the port of
    ``paged_prefill_kernel``; in bf16 the tensor-core body it shares with
    K5 (``csrc/paged_prefill_body.cuh``), short chunks' key tiles split
    over ``prefill_splits`` blocks.
  * ``paged_ring_prefill_kernel`` — K5, chunked prefill and verify on
    ring pages, snapshot-before-write: ``csrc/paged_ring_prefill.cu``, the
    port of ``paged_ring_prefill_kernel``.
  * ``paged_mla_kernel`` — K6, absorbed-MLA decode over latent pages:
    ``csrc/paged_mla.cu``, the port of ``paged_mla_kernel``; in bf16 every
    slot's live pages split over ``mla_decode_splits`` blocks, one
    thread-block cluster a slot, merged in the same launch.
  * ``paged_mla_prefill_kernel`` — K7, absorbed-MLA chunked prefill and
    verify: ``csrc/paged_mla_prefill.cu``, the port of
    ``paged_mla_prefill_kernel``; in bf16 blocks of 4 queries on the
    tensor cores, every block's key tiles (its last live query's causal
    horizon, in 32-key tiles) split over ``mla_prefill_splits`` blocks,
    one thread-block cluster a query block, merged in the same launch.

K8 — int8 pages — is the ``k_scale`` / ``v_scale`` operands of K1, K2, K4
and K5: int8 k/v pages with one bf16 scale per (page, offset, kv-head)
row, dequantized inside the kernel (fp pages are never materialized).

Each wrapper takes the plain PyTorch version (``ref.py``) for tensors on
the CPU — and only there.  For CUDA tensors it checks device, dtype, shape
and contiguity, allocates the output with ``torch.empty``, launches the
kernel on the current stream, raises if the launch was refused, and adds
one to its ``launches`` counter (under CUDA-graph capture, to the
capture's tally, which every replay adds: ``kernels/common.py``); there
is no fallback.  The library builds from the repo's sources on the first
CUDA launch (``kernels/build.py``).  The decode wrappers (K1 / K4, K6)
are captured in the engine's decode graphs: their split counts are
functions of shapes, and their launchers set the shared-memory attribute
with ``cudaFuncSetAttribute``, which is not a stream operation and is
legal while a stream captures.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import KERNEL_DTYPES as _DTYPES
from repro_torch.kernels.common import check_tensor as _check
from repro_torch.kernels.common import count_launch as _count_launch
from repro_torch.kernels.common import hold_scratch as _hold
from repro_torch.kernels.common import lib_fn as _lib
from repro_torch.kernels.common import raise_on as _raise_on
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_mla_attention_ref, paged_mla_prefill_ref,
    paged_prefill_ref, paged_ring_prefill_ref)

_HEAD_DIMS = (64, 128, 256)
#: head dims the bf16 tensor-core body of K2 / K5 is instantiated for (the
#: ring families': mixtral 128), and so all K5 takes; K2's bf16 hd 256
#: runs its scalar body, unsplit
PREFILL_MMA_HEAD_DIMS = (64, 128)
#: the largest GQA group K2 holds (MAXG in paged_prefill.cu)
PREFILL_MAX_G = 8

#: (H, R, rp) geometries K6 / K7 are instantiated for: deepseek-v2-lite at
#: full width and the smoke config (``launch_geom`` in the CUDA sources)
MLA_GEOMS = ((16, 512, 64), (4, 32, 8))
#: page sizes K6 / K7 take (the fp32 shared-memory tile is ps x (R + rp))
MLA_PAGE_SIZES = range(8, 65)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(wrapper, kind: str) -> None:
    """One launch: the wrapper's ``launches`` and its ``launches_by`` page
    kind ("fp" / "int8", "ring" / "ring_int8" for K4 and its K8 branch),
    which tell K1 from K4 and either from its int8 branch (K8); under
    CUDA-graph capture, the capture's tally (``kernels/common.py``)."""
    _count_launch(wrapper, kind)


def _check_pages(q, k_pages, v_pages, k_scale=None, v_scale=None,
                 head_dims=_HEAD_DIMS):
    """Device, dtype, shape and alignment checks of per-head pages: in
    q's dtype, or int8 with bf16 ``k_scale`` / ``v_scale`` [P, ps, KV].
    Returns whether the pages are int8."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {sorted(map(str, _DTYPES))}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together (int8 pages)")
    quantized = k_scale is not None
    page_dtype = torch.int8 if quantized else q.dtype
    for t, name in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        _check(t, name, page_dtype, q.device, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v page shapes differ: {tuple(k_pages.shape)} "
                         f"vs {tuple(v_pages.shape)}")
    hd = k_pages.shape[-1]
    if hd not in head_dims:
        raise ValueError(f"head_dim {hd} not in the CUDA kernels' "
                         f"{head_dims}")
    if quantized:
        # int8 rows load as 16-byte vectors of 16 values
        if hd % 16:
            raise ValueError(f"int8 pages need head_dim % 16 == 0, got {hd}")
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            _check(t, name, torch.bfloat16, q.device, 3)
            if t.shape != k_pages.shape[:-1]:
                raise ValueError(f"{name} {tuple(t.shape)} does not match "
                                 f"pages {tuple(k_pages.shape)}")
    return quantized


#: keys a warp of the decode kernel takes at once, the warps of a block and
#: the query heads a block holds (PD_KEYS / PD_MAX_WARPS / PD_MAXG in
#: csrc/paged_attention.cu)
DECODE_KEYS, DECODE_WARPS, DECODE_MAX_G = 16, 4, 8
#: the decode kernel splits slots' pages until about this many blocks per
#: SM run, never into more than DECODE_MAX_SPLITS (PD_MAX_SPLITS)
DECODE_BLOCKS_PER_SM = 2
DECODE_MAX_SPLITS = 64


def decode_live_pages(length: int, n_table: int, ps: int, window: int) -> int:
    """Pages of a slot the decode kernel reads: its live cells — ``length``,
    on the ring saturated at the window — within the table, rounded up to
    whole pages (the kernel computes this from ``lengths`` on the device)."""
    cells = min(length, window) if window > 0 else length
    return -(-max(0, min(cells, n_table * ps)) // ps)


def decode_split_cap(n_table: int, ps: int, window: int) -> int:
    """The most splits a decode launch over this table takes: a full slot's
    split holds at least one page and keeps every warp of its block busy
    (``DECODE_WARPS`` rounds of ``DECODE_KEYS`` keys)."""
    cells = min(n_table * ps, window) if window > 0 else n_table * ps
    return max(1, min(DECODE_MAX_SPLITS, -(-cells // ps),
                      cells // (DECODE_KEYS * DECODE_WARPS)))


@functools.lru_cache(maxsize=None)
def decode_splits(slots: int, KV: int, n_table: int, ps: int, window: int,
                  sms: int) -> int:
    """How many page ranges (``blockIdx.z``) the decode launch splits every
    slot's live pages into: enough for ``DECODE_BLOCKS_PER_SM`` blocks per
    SM over slots x KV, capped by ``decode_split_cap``.  A function of the
    shapes, never of ``lengths`` (a device value: reading it would sync the
    host on every layer of every decode step)."""
    want = -(-DECODE_BLOCKS_PER_SM * sms // (slots * KV))
    return max(1, min(want, decode_split_cap(n_table, ps, window)))


_SCRATCH: dict = {}


def _decode_scratch(device, stream: int, n_ws: int, n_counters: int):
    """The split decode's fp32 workspace and merge counters on ``device``
    for ``stream``, kept across launches (the launches of one stream run
    one after another, so they share them): the counters are zeroed once
    here and left zero by every launch.  Grown when a launch needs more,
    by reallocation: a CUDA graph captured with the old pair holds it
    (``hold_scratch``), so growth never frees memory a graph points at."""
    ws, counters = _SCRATCH.get((device, stream), (None, None))
    if ws is None or ws.numel() < n_ws or counters.numel() < n_counters:
        ws = torch.empty(max(n_ws, 1 << 16), dtype=torch.float32,
                         device=device)
        counters = torch.zeros(max(n_counters, 1024), dtype=torch.int32,
                               device=device)
        _SCRATCH[device, stream] = ws, counters
    _hold(ws, counters)
    return ws, counters


def paged_attention_kernel(q, k_pages, v_pages, page_table, lengths, *,
                           window: int = 0, k_scale=None, v_scale=None,
                           _splits=None):
    """K1 (``window == 0``) / K4 (``window > 0``, ring pages); int8 pages
    with ``k_scale`` / ``v_scale`` (K8).  q: [slots, KV, G, hd]; k/v_pages:
    [P, ps, KV, hd]; page_table: [slots, n_table] int32; lengths: [slots]
    int32.  Returns [slots, KV, G, hd] in q.dtype (0 for a slot with
    length 0).  Every slot's live pages split over ``decode_splits``
    blocks (``_splits`` overrides that count, for the tests that hold
    split and unsplit launches together); one launch either way."""
    slots, KV, G, hd = q.shape
    if q.device.type == "cpu":
        out = paged_attention_ref(q.reshape(slots, KV * G, hd), k_pages,
                                  v_pages, page_table, lengths,
                                  window=window, k_scale=k_scale,
                                  v_scale=v_scale)
        return out.reshape(slots, KV, G, hd)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    _check(q, "q", q.dtype, q.device, 4)
    quantized = _check_pages(q, k_pages, v_pages, k_scale, v_scale)
    _check(page_table, "page_table", torch.int32, q.device, 2)
    _check(lengths, "lengths", torch.int32, q.device, 1)
    P, ps, kv_p, hd_p = k_pages.shape
    n_table = page_table.shape[1]
    if (kv_p, hd_p) != (KV, hd) or page_table.shape[0] != slots \
            or lengths.shape[0] != slots:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages {tuple(k_pages.shape)},"
            f" table {tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    if not 1 <= G <= 32:
        raise ValueError(f"GQA group {G} outside the kernel's 1..32")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if quantized and ps * KV % 2:
        raise ValueError(f"int8 pages need page_size x KV even (scales load "
                         f"as 4-byte words), got {ps} x {KV}")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    splits = _splits or decode_splits(slots, KV, n_table, ps, window,
                                      _sm_count(q.device.index or 0))
    if not 1 <= splits <= DECODE_MAX_SPLITS:
        raise ValueError(f"splits {splits} outside 1..{DECODE_MAX_SPLITS}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if splits > 1:
        ws, counters = _decode_scratch(
            q.device, stream, slots * KV * G * splits * (hd + 2),
            slots * KV * -(-G // DECODE_MAX_G))
    out = torch.empty_like(q)
    fn = _lib("paged_attention", "paged_attention_launch",
              [_P] * 10 + [_I] * 10 + [_P])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), _ptr(ws), _ptr(counters),
             slots, KV, G, hd, ps, n_table, int(window), _DTYPES[q.dtype],
             int(quantized), int(splits), stream)
    _raise_on(err, "paged_attention")
    _count(paged_attention_kernel, ("ring_" if window else "")
           + ("int8" if quantized else "fp"))
    return out


paged_attention_kernel.launches = 0
paged_attention_kernel.launches_by = {}


def _check_chunk(q, page_row, start: int, n_valid: int):
    S, KV, G, hd = q.shape
    _check(q, "q", q.dtype, q.device, 4)
    _check(page_row, "page_row", torch.int32, q.device, 1)
    if not 1 <= G <= PREFILL_MAX_G:
        raise ValueError(f"GQA group {G} outside the kernel's "
                         f"1..{PREFILL_MAX_G}")
    if not 0 <= n_valid <= S or start < 0:
        raise ValueError(f"bad chunk bounds start={start} n_valid={n_valid}"
                         f" for S={S}")


def paged_prefill_kernel(q, k_pages, v_pages, page_row, start: int,
                         n_valid: int, *, k_scale=None, v_scale=None,
                         _splits=None):
    """K2; int8 pages with ``k_scale`` / ``v_scale`` (K8).  q: [S, KV, G,
    hd] — one request's bucketed chunk (post-rope); k/v_pages: [P, ps, KV,
    hd] — the pool AFTER the chunk's K/V were written; page_row: [n]
    int32, ``start + n_valid <= n * ps``; start / n_valid ints.  Returns
    [S, KV, G, hd] in q.dtype; rows past ``n_valid`` are padding and come
    back 0 from the kernel (never read by callers).  bf16 at hd 64 / 128
    runs the tensor-core body, its key tiles split by ``prefill_splits``
    (``_splits`` overrides that count, for the tests that hold split and
    unsplit launches together); fp32, and bf16 at hd 256, the scalar
    body."""
    S, KV, G, hd = q.shape
    if q.device.type == "cpu":
        out = paged_prefill_ref(q.reshape(S, KV * G, hd), k_pages, v_pages,
                                page_row, start, n_valid, k_scale=k_scale,
                                v_scale=v_scale)
        return out.reshape(S, KV, G, hd)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-prefill kernel for {q.device}")
    _check_chunk(q, page_row, start, n_valid)
    quantized = _check_pages(q, k_pages, v_pages, k_scale, v_scale)
    P, ps, kv_p, hd_p = k_pages.shape
    if (kv_p, hd_p) != (KV, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    if start + n_valid > page_row.shape[0] * ps:
        raise ValueError(f"chunk end {start + n_valid} past the table's "
                         f"{page_row.shape[0]} x {ps} cells")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    if q.dtype == torch.bfloat16 and hd in PREFILL_MMA_HEAD_DIMS:
        splits = _splits or prefill_splits(S, G, KV, start, n_valid,
                                           _sm_count(q.device.index or 0))
    elif _splits not in (None, 1):
        raise ValueError("only the bf16 tensor-core body splits its key "
                         "tiles")
    else:
        splits = 1
    out = torch.empty_like(q)
    fn = _lib("paged_prefill", "paged_prefill_launch",
              [_P] * 8 + [_I] * 11 + [_P])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), page_row.data_ptr(),
             out.data_ptr(), _ptr(_prefill_ws(q, splits)), S, KV, G, hd, ps,
             page_row.shape[0], int(start), int(n_valid), _DTYPES[q.dtype],
             int(quantized), int(splits),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_prefill")
    _count(paged_prefill_kernel, "int8" if quantized else "fp")
    return out


paged_prefill_kernel.launches = 0
paged_prefill_kernel.launches_by = {}


#: query rows and key positions per tile of the bf16 K2 / K5 body (RP_BM /
#: RP_BK in csrc/paged_prefill_body.cuh)
PREFILL_ROW_TILE = PREFILL_KEY_TILE = 64
#: the body splits its blocks' key tiles until about this many blocks per
#: SM run, never into more than PREFILL_MAX_SPLITS
PREFILL_SPLIT_BLOCKS_PER_SM = 2
PREFILL_MAX_SPLITS = 64


def prefill_key_tiles(r0: int, G: int, start: int, n_valid: int,
                      window: int = 0) -> int:
    """Key tiles the bf16 K2 / K5 block of query rows ``[r0, r0 + 64)``
    (rows ``r = i * G + g``) walks: the positions some row of it keeps, up
    to the last valid row's own position, from 0 on contiguous pages
    (``window`` 0, K2) or from the first row's window edge on a ring (K5)
    (``PrefillKeys`` in the source); 0 for a block of padding rows."""
    r_hi = min(r0 + PREFILL_ROW_TILE, n_valid * G)
    if r0 >= r_hi:
        return 0
    lo = max(0, start + r0 // G - window + 1) if window > 0 else 0
    hi = start + (r_hi - 1) // G + 1
    return -(-(hi - lo) // PREFILL_KEY_TILE)


def prefill_splits(S: int, G: int, KV: int, start: int, n_valid: int,
                   sms: int, window: int = 0) -> int:
    """How many contiguous key ranges (``blockIdx.z``) the bf16 K2 / K5
    launch splits every block's key tiles into: 1 when KV x row tiles
    already fill ``PREFILL_SPLIT_BLOCKS_PER_SM`` blocks per SM, else enough
    to, but never more than the fewest tiles of a block (no split is
    empty) or ``PREFILL_MAX_SPLITS``.  A function of the shapes and the
    chunk's host-side bounds, not a setting."""
    row_tiles = -(-n_valid * G // PREFILL_ROW_TILE)
    target = PREFILL_SPLIT_BLOCKS_PER_SM * sms
    if row_tiles == 0 or KV * row_tiles >= target:
        return 1
    fewest = min(prefill_key_tiles(r0, G, start, n_valid, window)
                 for r0 in range(0, n_valid * G, PREFILL_ROW_TILE))
    return max(1, min(-(-target // (KV * row_tiles)), fewest,
                      PREFILL_MAX_SPLITS))


def _prefill_ws(q, splits: int):
    """The split partials of a K2 / K5 launch: splits x KV x rows_pad x
    (hd + 2) fp32, rows_pad = 64 * ceil(S * G / 64); None unsplit."""
    if splits == 1:
        return None
    S, KV, G, hd = q.shape
    rows_pad = -(-S * G // PREFILL_ROW_TILE) * PREFILL_ROW_TILE
    return torch.empty(splits * KV * rows_pad * (hd + 2),
                       dtype=torch.float32, device=q.device)


def split_range(n_tiles: int, splits: int, z: int):
    """Key tiles (K2 / K5) or live pages (K1 / K4, K6) ``[lo, hi)`` of split
    ``z``, as the kernels cut them."""
    return z * n_tiles // splits, (z + 1) * n_tiles // splits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_ring_prefill_kernel(q, k_pages, v_pages, chunk_k, chunk_v,
                              page_row, start: int, n_valid: int, *,
                              window: int, k_scale=None, v_scale=None,
                              _splits=None):
    """K5; int8 snapshot pages with ``k_scale`` / ``v_scale`` (K8).  q:
    [S, KV, G, hd] — one request's bucketed chunk (post-rope); k/v_pages:
    [P, ps, KV, hd] — the ring BEFORE the chunk's writes; chunk_k/chunk_v:
    [S, KV, hd] — the chunk's own keys / values in q's dtype; page_row:
    [n] int32 — the request's ring of cells.  Returns [S, KV, G, hd] in
    q.dtype; rows past ``n_valid`` come back 0 (never read by callers).
    bf16 runs the tensor-core body, its key tiles split by
    ``prefill_splits`` (``_splits`` overrides that count, for the tests
    that hold split and unsplit launches together); fp32 the scalar
    kernel."""
    S, KV, G, hd = q.shape
    if q.device.type == "cpu":
        out = paged_ring_prefill_ref(q.reshape(S, KV * G, hd), k_pages,
                                     v_pages, chunk_k, chunk_v, page_row,
                                     start, n_valid, window=window,
                                     k_scale=k_scale, v_scale=v_scale)
        return out.reshape(S, KV, G, hd)
    if q.device.type != "cuda":
        raise ValueError(f"no paged ring-prefill kernel for {q.device}")
    _check_chunk(q, page_row, start, n_valid)
    quantized = _check_pages(q, k_pages, v_pages, k_scale, v_scale,
                             PREFILL_MMA_HEAD_DIMS)
    for t, name in ((chunk_k, "chunk_k"), (chunk_v, "chunk_v")):
        _check(t, name, q.dtype, q.device, 3)
        if tuple(t.shape) != (S, KV, hd):
            raise ValueError(f"{name} {tuple(t.shape)} is not {(S, KV, hd)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    P, ps, kv_p, hd_p = k_pages.shape
    if (kv_p, hd_p) != (KV, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    if window <= 0 or page_row.shape[0] * ps > window:
        raise ValueError(f"ring of {page_row.shape[0]} cells x {ps} does not "
                         f"fit window {window}")
    if q.dtype == torch.bfloat16:
        splits = _splits or prefill_splits(
            S, G, KV, start, n_valid, _sm_count(q.device.index or 0),
            window)
    elif _splits not in (None, 1):
        raise ValueError("only the bf16 kernel splits its key tiles")
    else:
        splits = 1
    out = torch.empty_like(q)
    fn = _lib("paged_ring_prefill", "paged_ring_prefill_launch",
              [_P] * 10 + [_I] * 12 + [_P])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), chunk_k.data_ptr(),
             chunk_v.data_ptr(), page_row.data_ptr(), out.data_ptr(),
             _ptr(_prefill_ws(q, splits)), S, KV, G, hd, ps, page_row.shape[0], int(start),
             int(n_valid), int(window), _DTYPES[q.dtype], int(quantized),
             int(splits), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_ring_prefill")
    _count(paged_ring_prefill_kernel, "int8" if quantized else "fp")
    return out


paged_ring_prefill_kernel.launches = 0
paged_ring_prefill_kernel.launches_by = {}


def _check_mla(q_lat, q_rope, ckv_pages, krope_pages):
    """Device, dtype, shape and alignment checks shared by K6 and K7;
    returns (H, R, rp, ps)."""
    if q_lat.dtype not in _DTYPES:
        raise ValueError(f"q_lat dtype {q_lat.dtype} not in "
                         f"{sorted(map(str, _DTYPES))}")
    _check(q_lat, "q_lat", q_lat.dtype, q_lat.device, 3)
    _check(q_rope, "q_rope", q_lat.dtype, q_lat.device, 3)
    _check(ckv_pages, "ckv_pages", q_lat.dtype, q_lat.device, 3)
    _check(krope_pages, "krope_pages", q_lat.dtype, q_lat.device, 3)
    for t, name in ((ckv_pages, "ckv_pages"), (krope_pages, "krope_pages")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _, H, R = q_lat.shape
    rp = q_rope.shape[-1]
    P, ps, r_p = ckv_pages.shape
    if q_rope.shape[:2] != q_lat.shape[:2] or r_p != R \
            or tuple(krope_pages.shape) != (P, ps, rp):
        raise ValueError(
            f"shape mismatch: q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, ckv_pages {tuple(ckv_pages.shape)}, "
            f"krope_pages {tuple(krope_pages.shape)}")
    if (H, R, rp) not in MLA_GEOMS:
        raise ValueError(f"MLA geometry (H, R, rp) = {(H, R, rp)} not in "
                         f"the CUDA kernels' {MLA_GEOMS}")
    if ps not in MLA_PAGE_SIZES:
        raise ValueError(f"page size {ps} outside the MLA kernels' "
                         f"{MLA_PAGE_SIZES.start}..{MLA_PAGE_SIZES.stop - 1}")
    return H, R, rp, ps


#: the most splits a bf16 K6 / K7 launch takes (MD_MAX_SPLITS in
#: csrc/paged_mla.cu, MP_MAX_SPLITS in csrc/paged_mla_prefill.cu): a slot's
#: or a query block's splits are one cluster, of portable size
MLA_MAX_SPLITS = 8


def mla_decode_split_cap(n_table: int) -> int:
    """The most splits a bf16 K6 launch over this table takes: a full
    slot's split holds at least one page."""
    return max(1, min(MLA_MAX_SPLITS, n_table))


@functools.lru_cache(maxsize=None)
def mla_decode_splits(slots: int, n_table: int, sms: int) -> int:
    """How many page ranges (``blockIdx.y``, one cluster a slot) the bf16
    K6 launch splits every slot's live pages into: about one block per SM
    over the slots, capped by ``mla_decode_split_cap``, rounded down to a
    power of two (clusters of 3 or 6 blocks ran slower on the card than 4,
    PERF.md).  A function of the shapes, never of ``lengths`` (a device
    value: reading it would sync the host on every layer of every decode
    step)."""
    want = min(max(1, sms // slots), mla_decode_split_cap(n_table))
    return 1 << (want.bit_length() - 1)


def paged_mla_kernel(q_lat, q_rope, ckv_pages, krope_pages, page_table,
                     lengths, *, scale: float, _splits=None):
    """K6.  q_lat: [slots, H, R]; q_rope: [slots, H, rp]; ckv_pages:
    [P, ps, R]; krope_pages: [P, ps, rp]; page_table: [slots, n_table]
    int32; lengths: [slots] int32.  ``scale`` is the qk-dimension softmax
    scale.  Returns the latent output [slots, H, R] in q_lat.dtype (0 for a
    slot with length 0).  bf16 splits every slot's live pages over
    ``mla_decode_splits`` blocks, one cluster a slot (``_splits``
    overrides that count, for the tests that hold split and unsplit
    launches together), merged in the same launch through the cluster's
    shared memory; fp32 runs the scalar body, one block a slot."""
    if q_lat.device.type == "cpu":
        return paged_mla_attention_ref(q_lat, q_rope, ckv_pages,
                                       krope_pages, page_table, lengths,
                                       scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"no paged-MLA kernel for {q_lat.device}")
    H, R, rp, ps = _check_mla(q_lat, q_rope, ckv_pages, krope_pages)
    slots = q_lat.shape[0]
    _check(page_table, "page_table", torch.int32, q_lat.device, 2)
    _check(lengths, "lengths", torch.int32, q_lat.device, 1)
    if page_table.shape[0] != slots or lengths.shape[0] != slots:
        raise ValueError(f"shape mismatch: q_lat {tuple(q_lat.shape)}, "
                         f"table {tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    for t, name in ((q_lat, "q_lat"), (q_rope, "q_rope")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    n_table = page_table.shape[1]
    if q_lat.dtype == torch.bfloat16:
        splits = _splits or mla_decode_splits(
            slots, n_table, _sm_count(q_lat.device.index or 0))
    elif _splits not in (None, 1):
        raise ValueError("only the bf16 kernel splits its pages")
    else:
        splits = 1
    if not 1 <= splits <= MLA_MAX_SPLITS:
        raise ValueError(f"splits {splits} outside 1..{MLA_MAX_SPLITS}")
    out = torch.empty_like(q_lat)
    fn = _lib("paged_mla", "paged_mla_launch",
              [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P])
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(),
             krope_pages.data_ptr(), page_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), slots, H, R, rp, ps,
             n_table, float(scale), _DTYPES[q_lat.dtype], int(splits),
             torch.cuda.current_stream(q_lat.device).cuda_stream)
    _raise_on(err, "paged_mla")
    _count_launch(paged_mla_kernel)
    return out


paged_mla_kernel.launches = 0


#: queries a block of the bf16 K7 kernel holds and keys a tile (a round)
#: of its key walk (MP_QG / MP_KEYS in csrc/paged_mla_prefill.cu)
MLA_PREFILL_QUERIES, MLA_PREFILL_KEYS = 4, 32


def mla_prefill_key_tiles(q0: int, start: int, n_valid: int) -> int:
    """Key tiles the bf16 K7 block of queries ``[q0, q0 + 4)`` walks: keys
    ``[0, start + i + 1)`` for ``i`` its last live query (``< n_valid``),
    its causal horizon, in 32-key tiles; 0 for a block of padding
    queries."""
    qv = min(q0 + MLA_PREFILL_QUERIES, n_valid)
    if qv <= q0:
        return 0
    return -(-(start + qv) // MLA_PREFILL_KEYS)


#: what the bf16 K7 kernel's cluster merge costs, in key rounds (the
#: card's forced-split sweep in chip_smoke.py: about one 32-key round)
MLA_PREFILL_MERGE_ROUNDS = 1


@functools.lru_cache(maxsize=None)
def mla_prefill_splits(S: int, start: int, n_valid: int, sms: int) -> int:
    """How many key-tile ranges (``blockIdx.y``, one cluster a query block)
    the bf16 K7 launch splits every query block's key tiles into: the
    fewest that bring the longest block's rounds plus the merge's
    (``MLA_PREFILL_MERGE_ROUNDS``, 0 unsplit) to their least, within about
    one block per SM over the blocks with live queries and
    ``MLA_MAX_SPLITS``; a block with fewer tiles leaves splits empty.  A
    function of the shapes and the chunk's host-side bounds (``S`` only
    bounds ``n_valid``), not a setting, and no host sync."""
    blocks = range(0, min(S, n_valid), MLA_PREFILL_QUERIES)
    if not blocks:
        return 1
    most = max(mla_prefill_key_tiles(q0, start, n_valid) for q0 in blocks)
    cap = max(1, min(sms // len(blocks), MLA_MAX_SPLITS))
    return min(range(1, cap + 1), key=lambda n: (
        -(-most // n) + (MLA_PREFILL_MERGE_ROUNDS if n > 1 else 0), n))


def paged_mla_prefill_kernel(q_lat, q_rope, ckv_pages, krope_pages,
                             page_row, start: int, n_valid: int, *,
                             scale: float, _splits=None):
    """K7.  q_lat: [S, H, R] — one request's bucketed chunk absorbed
    through W_uk; q_rope: [S, H, rp]; ckv/krope_pages: the latent pool
    AFTER the chunk's latents were written; page_row: [n] int32, ``start
    + n_valid <= n * ps``; start / n_valid ints.  Returns the latent output
    [S, H, R] in q_lat.dtype; rows past ``n_valid`` are padding and come
    back 0 from the kernel (never read by callers).  bf16 runs blocks of 4
    queries on the tensor cores, every block's key tiles split over
    ``mla_prefill_splits`` blocks, one cluster a query block (``_splits``
    overrides that count, for the tests that hold split and unsplit
    launches together), merged in the same launch through the cluster's
    shared memory; fp32 runs the scalar body, one block a query."""
    if q_lat.device.type == "cpu":
        return paged_mla_prefill_ref(q_lat, q_rope, ckv_pages, krope_pages,
                                     page_row, start, n_valid, scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"no paged-MLA prefill kernel for {q_lat.device}")
    H, R, rp, ps = _check_mla(q_lat, q_rope, ckv_pages, krope_pages)
    S = q_lat.shape[0]
    _check(page_row, "page_row", torch.int32, q_lat.device, 1)
    if not 0 <= n_valid <= S or start < 0:
        raise ValueError(f"bad chunk bounds start={start} n_valid={n_valid}"
                         f" for S={S}")
    if start + n_valid > page_row.shape[0] * ps:
        raise ValueError(f"chunk end {start + n_valid} past the table's "
                         f"{page_row.shape[0]} x {ps} cells")
    for t, name in ((q_lat, "q_lat"), (q_rope, "q_rope")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q_lat.dtype == torch.bfloat16:
        splits = _splits or mla_prefill_splits(
            S, int(start), int(n_valid), _sm_count(q_lat.device.index or 0))
    elif _splits not in (None, 1):
        raise ValueError("only the bf16 kernel splits its key tiles")
    else:
        splits = 1
    if not 1 <= splits <= MLA_MAX_SPLITS:
        raise ValueError(f"splits {splits} outside 1..{MLA_MAX_SPLITS}")
    out = torch.empty_like(q_lat)
    fn = _lib("paged_mla_prefill", "paged_mla_prefill_launch",
              [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P])
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(),
             krope_pages.data_ptr(), page_row.data_ptr(), out.data_ptr(), S,
             H, R, rp, ps, page_row.shape[0], int(start), int(n_valid),
             float(scale), _DTYPES[q_lat.dtype], int(splits),
             torch.cuda.current_stream(q_lat.device).cuda_stream)
    _raise_on(err, "paged_mla_prefill")
    _count_launch(paged_mla_prefill_kernel)
    return out


paged_mla_prefill_kernel.launches = 0
