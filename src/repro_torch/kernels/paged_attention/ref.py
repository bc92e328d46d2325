"""Plain PyTorch versions of the paged-attention kernels (contiguous fp pages).

Layouts (the serving pool's native shapes):
  * ``q``          [slots, H, hd]   — one query token per decode slot
  * ``k/v_pages``  [P, ps, KV, hd]  — per-head page pool (page 0 is the
                                      reserved trash page)
  * ``ckv/krope_pages`` [P, ps, R] / [P, ps, rp] — latent page pool (MLA)
  * ``page_table`` [slots, n] int32 — per-slot page ids; entries past a
                                      slot's held pages point at page 0
  * ``lengths``    [slots] int32    — tokens cached per slot

Token t of slot s lives at page ``page_table[s, t // ps]``, offset
``t % ps``; validity is ``index < length``.  GQA head convention: head h
reads kv-head ``h // G`` (reshape H -> (KV, G)).

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


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """Decode attention.  Returns [slots, H, hd] in q.dtype."""
    S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    n = page_table.shape[1]
    G = H // KV
    scale = hd ** -0.5
    table = page_table.long()
    k = k_pages[table].reshape(S, n * ps, KV, hd)           # gather-all
    v = v_pages[table].reshape(S, n * ps, KV, hd)
    idx = torch.arange(n * ps, device=q.device)
    valid = idx[None, :] < lengths.to(q.device)[:, None]    # [S, n*ps]
    q_ = q.reshape(S, KV, G, hd).float()
    s = torch.einsum("skgh,stkh->skgt", q_, k.float()) * scale
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
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

def _prefill_attend(q, k, v, valid, scale):
    """Masked full-softmax core: q [S, KV, G, hd], k/v [T, KV, hd],
    valid [S, T] -> [S, KV*G, hd] in fp32."""
    S, KV, G, hd = q.shape
    s = torch.einsum("skgh,tkh->skgt", q.float(), k.float()) * scale
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("skgt,tkh->skgh", p, v.float())
    return out.reshape(S, KV * G, hd)


def paged_prefill_ref(q, k_pages, v_pages, page_table, start: int,
                      n_valid: int):
    """The pages already hold the chunk's K/V (positions
    start..start+n_valid-1), so queries attend the gathered pages under the
    written bound AND the causal horizon.  Returns [S, H, hd] in q.dtype."""
    S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    n = page_table.shape[0]
    table = page_table.long()
    k = k_pages[table].reshape(n * ps, KV, hd)
    v = v_pages[table].reshape(n * ps, KV, hd)
    kidx = torch.arange(n * ps, device=q.device)
    qpos = start + torch.arange(S, device=q.device)
    valid = (kidx[None, :] < start + n_valid) \
        & (kidx[None, :] <= qpos[:, None])
    out = _prefill_attend(q.reshape(S, KV, H // KV, hd), k, v, valid,
                          hd ** -0.5)
    return out.to(q.dtype)


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
