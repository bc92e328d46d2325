"""Plain PyTorch versions of the paged-attention kernels.

Layouts (the serving pool's native shapes):
  * ``q``          [slots, H, hd]   — one query token per decode slot
  * ``k/v_pages``  [P, ps, KV, hd]  — per-head page pool (page 0 is the
                                      reserved trash page)
  * ``k/v_scale``  [P, ps, KV] bf16 — int8 pages only: one scale per
                                      (page, offset, kv-head) row
  * ``ckv/krope_pages`` [P, ps, R] / [P, ps, rp] — latent page pool (MLA)
  * ``page_table`` [slots, n] int32 — per-slot page ids; entries past a
                                      slot's held pages point at page 0
  * ``lengths``    [slots] int32    — tokens cached per slot

Position mapping is the layout's:
  * contiguous — token t of slot s lives at page ``page_table[s, t // ps]``,
    offset ``t % ps``; validity is ``index < length``;
  * ring (``window > 0``) — the table is a ring of ``window // ps`` cells;
    ring index i holds the latest position ``p = cur - ((cur - i) mod
    window)`` with ``cur = length - 1`` and a *floor* modulo; ``p >= 0``
    is the validity mask, which is also the sliding-window mask.

GQA head convention: head h reads kv-head ``h // G`` (reshape H -> (KV,
G)).  Int8 pages dequantize fused, as the kernels do: raw scores times
the key's scale per column, probabilities times the value's scale per row
before the PV product, the softmax denominator unscaled.

These gather the whole table and materialize the [slots, n*ps] score
matrix — correctness only.  They are what the kernel wrappers run for CPU
tensors, what the CPU tests hold against the JAX oracles, and what
``chip_smoke.py`` holds the CUDA kernels against on the card.  A fully
masked row comes out as a uniform average here while the kernels emit 0
there; callers only ever read slots with ``length >= 1`` and prefill rows
``< n_valid``, so comparisons look at those only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def ring_positions(lengths, n_tokens: int, window: int):
    """Absolute position held by each ring index (module docstring):
    lengths [slots] -> ([slots, n_tokens] positions, validity).  The
    modulo is a floor modulo (``torch.remainder``), as ``jnp.mod``: for a
    slot shorter than the window, ``cur - i`` is negative on the cells
    never written, and those must come out negative."""
    cur = lengths.long()[:, None] - 1
    i = torch.arange(n_tokens, device=lengths.device)[None, :]
    p = cur - torch.remainder(cur - i, window)
    return p, p >= 0


def _row_scales(scale, table, n_rows: int, KV: int):
    """Gathered per-row scales of a table (row) as fp32 [..., n_rows, KV]."""
    return scale[table.long()].float().reshape(*table.shape[:-1], n_rows, KV)


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        window: int = 0, k_scale=None, v_scale=None):
    """Decode attention.  ``window > 0`` selects the ring layout's position
    mapping; ``k_scale``/``v_scale`` mark int8 pages.  Returns
    [slots, H, hd] in q.dtype."""
    S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    n = page_table.shape[1]
    G = H // KV
    scale = hd ** -0.5
    table = page_table.long()
    k = k_pages[table].reshape(S, n * ps, KV, hd)           # gather-all
    v = v_pages[table].reshape(S, n * ps, KV, hd)
    lengths = lengths.to(q.device)
    if window:
        _, valid = ring_positions(lengths, n * ps, window)
    else:
        idx = torch.arange(n * ps, device=q.device)
        valid = idx[None, :] < lengths[:, None]             # [S, n*ps]
    q_ = q.reshape(S, KV, G, hd).float()
    s = torch.einsum("skgh,stkh->skgt", q_, k.float()) * scale
    if k_scale is not None:                                 # per key column
        ks = _row_scales(k_scale, page_table, n * ps, KV)   # [S, t, KV]
        s = s * ks.transpose(1, 2)[:, :, None, :]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:                                 # per value row
        vs = _row_scales(v_scale, page_table, n * ps, KV)
        p = p * vs.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("skgt,stkh->skgh", p, v.float())
    return out.reshape(S, H, hd).to(q.dtype)


def paged_mla_attention_ref(q_lat, q_rope, ckv_pages, krope_pages,
                            page_table, lengths, *, scale: float):
    """Absorbed MLA decode against latent pages (contiguous layout).

    q_lat [slots, H, R] — queries absorbed through W_uk into the latent
    space; q_rope [slots, H, rp]; ckv_pages [P, ps, R]; krope_pages
    [P, ps, rp].  ``scale`` is the *qk-dimension* softmax scale (the latent
    rank is not the score dimension).  Returns the latent-space output
    [slots, H, R] in q_lat.dtype — the caller up-projects through W_uv.
    """
    S, H, R = q_lat.shape
    _, ps, _ = ckv_pages.shape
    n = page_table.shape[1]
    table = page_table.long()
    ckv = ckv_pages[table].reshape(S, n * ps, R)
    kr = krope_pages[table].reshape(S, n * ps, krope_pages.shape[-1])
    s = torch.einsum("shr,str->sht", q_lat.float(), ckv.float())
    s = s + torch.einsum("shr,str->sht", q_rope.float(), kr.float())
    valid = torch.arange(n * ps, device=q_lat.device)[None, :] \
        < lengths.to(q_lat.device)[:, None]                  # [S, n*ps]
    s = torch.where(valid[:, None, :], s * scale,
                    torch.full((), NEG_INF, device=q_lat.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("sht,str->shr", p, ckv.float())
    return out.to(q_lat.dtype)


# ---------------------------------------------------------------------------
# Chunked prefill (one bucketed chunk of a single request)
#
# q is [S, H, hd] (H = KV * G); page_table is the request's single row [n];
# start / n_valid are ints — query i holds absolute position ``start + i``,
# the bucket tail (i >= n_valid) is padding whose output rows are never
# read.
# ---------------------------------------------------------------------------

def _prefill_attend(q, k, v, valid, scale, k_scale=None, v_scale=None):
    """Masked full-softmax core: q [S, KV, G, hd], k/v [T, KV, hd],
    valid [S, T] -> [S, KV*G, hd] in fp32.  Optional per-key-row scales
    ``k_scale``/``v_scale`` [T, KV] (fp32): raw scores times the key
    scale, probabilities times the value scale."""
    S, KV, G, hd = q.shape
    s = torch.einsum("skgh,tkh->skgt", q.float(), k.float()) * scale
    if k_scale is not None:
        s = s * k_scale.T[None, :, None, :]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.T[None, :, None, :]
    out = torch.einsum("skgt,tkh->skgh", p, v.float())
    return out.reshape(S, KV * G, hd)


def paged_prefill_ref(q, k_pages, v_pages, page_table, start: int,
                      n_valid: int, *, k_scale=None, v_scale=None):
    """The pages already hold the chunk's K/V (positions
    start..start+n_valid-1), so queries attend the gathered pages under the
    written bound AND the causal horizon.  ``k_scale``/``v_scale`` mark
    int8 pages.  Returns [S, H, hd] in q.dtype."""
    S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    n = page_table.shape[0]
    table = page_table.long()
    k = k_pages[table].reshape(n * ps, KV, hd)
    v = v_pages[table].reshape(n * ps, KV, hd)
    ks = (None if k_scale is None
          else _row_scales(k_scale, page_table, n * ps, KV))
    vs = (None if v_scale is None
          else _row_scales(v_scale, page_table, n * ps, KV))
    kidx = torch.arange(n * ps, device=q.device)
    qpos = start + torch.arange(S, device=q.device)
    valid = (kidx[None, :] < start + n_valid) \
        & (kidx[None, :] <= qpos[:, None])
    out = _prefill_attend(q.reshape(S, KV, H // KV, hd), k, v, valid,
                          hd ** -0.5, ks, vs)
    return out.to(q.dtype)


def paged_ring_prefill_ref(q, k_pages, v_pages, chunk_k, chunk_v,
                           page_row, start: int, n_valid: int, *,
                           window: int, k_scale=None, v_scale=None):
    """Ring-layout chunked prefill, snapshot-before-write: the pages are
    the PRE-write ring (the chunk's writes wrap onto cells its own early
    queries still need) and the chunk's own keys / values come as
    ``chunk_k``/``chunk_v`` [S, KV, hd].  Snapshot keys take ring
    positions (``cur = start - 1``), chunk keys ``start + j``; the
    sliding-window mask drops every wrapped-over snapshot cell.
    ``k_scale``/``v_scale`` mark int8 *snapshot* pages — the chunk
    operands stay fp, with scale 1.  Returns [S, H, hd] in q.dtype."""
    S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    n = page_row.shape[0]
    dev = q.device
    table = page_row.long()
    ring_k = k_pages[table].reshape(n * ps, KV, hd)
    ring_v = v_pages[table].reshape(n * ps, KV, hd)
    ring_pos, ring_ok = ring_positions(
        torch.tensor([start], device=dev), n * ps, window)
    if k_scale is not None:
        kk = torch.cat([ring_k.float(), chunk_k.float()])
        vv = torch.cat([ring_v.float(), chunk_v.float()])
        ones = torch.ones((S, KV), device=dev)
        ks = torch.cat([_row_scales(k_scale, page_row, n * ps, KV), ones])
        vs = torch.cat([_row_scales(v_scale, page_row, n * ps, KV), ones])
    else:
        kk = torch.cat([ring_k, chunk_k.to(ring_k.dtype)])
        vv = torch.cat([ring_v, chunk_v.to(ring_v.dtype)])
        ks = vs = None
    j = torch.arange(S, device=dev)
    k_pos = torch.cat([ring_pos[0], start + j])
    k_ok = torch.cat([ring_ok[0], j < n_valid])
    qpos = start + j
    valid = k_ok[None, :] & (k_pos[None, :] <= qpos[:, None]) \
        & (k_pos[None, :] > qpos[:, None] - window)
    out = _prefill_attend(q.reshape(S, KV, H // KV, hd), kk, vv, valid,
                          hd ** -0.5, ks, vs)
    return out.to(q.dtype)


def merge_partials_ref(m, l, acc):
    """Plain version of K5's split merge (``paged_ring_prefill_kernel_merge``):
    per-split softmax partials of the same rows — row max ``m`` and sum
    ``l`` [splits, rows], unnormalized ``acc`` [splits, rows, hd], all
    fp32 — folded into the rows' output [rows, hd]: each split rescaled by
    ``exp(m - max m)``, then divided by ``max(sum l, 1e-30)``.  A split
    that saw no live key of a row carries (NEG_INF, 0, 0) and weighs
    nothing; a row no split saw a live key of comes out 0 (its weights are
    ``exp(NEG_INF - NEG_INF) = 1`` on zero partials)."""
    w = torch.exp(m - m.amax(dim=0))
    lsum = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0)
    return out / torch.clamp(lsum, min=1e-30)[:, None]


def paged_mla_prefill_ref(q_lat, q_rope, ckv_pages, krope_pages,
                          page_table, start: int, n_valid: int, *,
                          scale: float):
    """Absorbed-MLA chunked prefill against latent pages (contiguous).
    q_lat [S, H, R] — queries absorbed through W_uk; pages hold the
    chunk's freshly written latents.  Returns the latent-space output
    [S, H, R] in q_lat.dtype — the caller up-projects through W_uv."""
    S, H, R = q_lat.shape
    _, ps, _ = ckv_pages.shape
    n = page_table.shape[0]
    table = page_table.long()
    ckv = ckv_pages[table].reshape(n * ps, R)
    kr = krope_pages[table].reshape(n * ps, krope_pages.shape[-1])
    s = torch.einsum("shr,tr->sht", q_lat.float(), ckv.float())
    s = s + torch.einsum("shr,tr->sht", q_rope.float(), kr.float())
    kidx = torch.arange(n * ps, device=q_lat.device)
    qpos = start + torch.arange(S, device=q_lat.device)
    valid = (kidx[None, :] < start + n_valid) \
        & (kidx[None, :] <= qpos[:, None])
    s = torch.where(valid[:, None, :], s * scale,
                    torch.full((), NEG_INF, device=q_lat.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("sht,tr->shr", p, ckv.float())
    return out.to(q_lat.dtype)
