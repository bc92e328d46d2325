"""Attention substrate: GQA (full causal and local / sliding-window
attention; contiguous pages) and DeepSeek MLA (latent pages).

Layouts: activations ``[batch, seq, d_model]``; heads ``[batch, seq, heads,
head_dim]`` — the JAX package's layouts, so the parity tests compare like
with like.

Execution paths:
  * ``attention_core``  — blocked online-softmax attention (train/prefill);
  * ``windowed_attention`` — sliding-window train/prefill attention over a
    per-query-block KV slice (subquadratic);
  * ``flash_vjp.flash_attention_vjp`` — train/prefill attention with O(S)
    residuals, its forward through kernel K3 (``use_kernels``);
  * ``decode_attend``   — single-step decode against a ring-buffer cache
    (windowed when the family is); the cache's position may be shared by
    its batch rows or kept per row (the slotted pool's slots);
  * ``paged_prefill_apply`` / ``paged_attention_apply`` — one prefill chunk
    / one batched decode step against the shared page pool — contiguous
    pages, or the ring-wrapped window pages of sliding-window families;
    fp or int8 (quantized on write, dequantized inside the attention) —
    through the hand-written CUDA kernels (``use_kernels``) or their plain
    versions (``repro_torch.kernels.paged_attention``);
  * ``mla_apply`` — MLA for train/prefill (expanded: per-head K/V made
    from the latents) and for one decode step against a ring cache
    (absorbed: scores in the latent space);
  * ``paged_mla_prefill_apply`` / ``paged_mla_attention_apply`` — MLA
    against the latent page pool.  Decode is absorbed (kernel K6 or its
    plain version).  Prefill is absorbed through kernel K7 with
    ``use_kernels`` and expanded without, as the JAX package's
    ``use_pallas`` chooses — two different computations of one function.

Tensor parallelism (a ``models.common.model_axis`` context): every path
runs on this rank's whole query heads (and KV heads, where they shard;
a single KV head is read by every rank's query heads), so each kernel is
called at the local head count; ``wo`` is row-parallel and its partial
sums meet in ``from_model``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.models.common import (ParamSpec, apply_rope, dot,
                                       from_model, local_extent, rms_norm,
                                       to_model)
from repro_torch.models.flash_vjp import flash_attention_vjp


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def attention_specs(cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    specs = {
        "wq": ParamSpec((d, h * hd), ("embed", "heads")),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((h * hd, d), ("heads", "embed2")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h * hd,), ("heads",), init="zeros")
        specs["bk"] = ParamSpec((kv * hd,), ("kv_heads",), init="zeros")
        specs["bv"] = ParamSpec((kv * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        # one scale per head_dim channel, shared by the heads
        specs["q_norm"] = ParamSpec((hd,), (None,), init="zeros")
        specs["k_norm"] = ParamSpec((hd,), (None,), init="zeros")
    return specs


def mla_specs(cfg):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    specs = {
        # compressed kv + shared rope key
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "rank")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("rank",), init="zeros"),
        "w_uk": ParamSpec((m.kv_lora_rank, h * m.qk_nope_head_dim), ("rank", "heads")),
        "w_uv": ParamSpec((m.kv_lora_rank, h * m.v_head_dim), ("rank", "heads")),
        "wo": ParamSpec((h * m.v_head_dim, d), ("heads", "embed2")),
    }
    if m.q_lora_rank:
        specs["w_dq"] = ParamSpec((d, m.q_lora_rank), ("embed", "rank"))
        specs["q_norm"] = ParamSpec((m.q_lora_rank,), ("rank",), init="zeros")
        specs["w_uq"] = ParamSpec((m.q_lora_rank, h * qk_dim), ("rank", "heads"))
    else:
        specs["wq"] = ParamSpec((d, h * qk_dim), ("embed", "heads"))
    return specs


# ---------------------------------------------------------------------------
# Blocked online-softmax attention (full / causal)
# ---------------------------------------------------------------------------

def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def local_heads(cfg):
    """(query heads, KV heads) on this rank: whole heads, as the rules
    shard them (``models.common.rules_for``)."""
    return (local_extent(cfg.num_heads, "heads"),
            local_extent(cfg.num_kv_heads, "kv_heads"))


def _kv_leaf(cfg, p, name):
    """A K/V projection leaf.  KV heads that replicate while the query
    heads shard are read by a part of the heads on each rank: their
    gradient is partial there and sums over the model axis."""
    w = p[name]
    if local_extent(cfg.num_kv_heads, "kv_heads") == cfg.num_kv_heads:
        w = to_model(w, "heads")
    return w


def _out_proj(p, out, cd):
    """The row-parallel output projection: local heads' partial sums
    all-reduced over the model axis."""
    return from_model(dot(out, p["wo"], cd), "heads")


def _project_qkv_rope(cfg, p, x, positions):
    """Shared GQA front half: q/k/v projections (+bias), head split, rope.

    x [B,S,D] -> q [B,S,H,hd], k/v [B,S,KV,hd] — used by the ring-cache
    (``attention_apply``) and paged (``paged_*_apply``) paths alike.
    """
    hd = cfg.resolved_head_dim
    H, KV = local_heads(cfg)
    cd = x.dtype
    x = to_model(x, "heads")
    q = dot(x, p["wq"], cd)
    k = dot(x, _kv_leaf(cfg, p, "wk"), cd)
    v = dot(x, _kv_leaf(cfg, p, "wv"), cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + _kv_leaf(cfg, p, "bk").to(cd)
        v = v + _kv_leaf(cfg, p, "bv").to(cd)
    q = _split_heads(q, H, hd)
    k = _split_heads(k, KV, hd)
    v = _split_heads(v, KV, hd)
    return (norm_rope(cfg, p, q, positions, "q"),
            norm_rope(cfg, p, k, positions, "k"), v)


def norm_rope(cfg, p, t, positions, which: str):
    """Queries or keys ``t`` [..., S, heads, hd] (``which`` "q" / "k")
    after their per-head RMS norm (``cfg.qk_norm``) and rope, which a
    global layer of ``rope_layers="windowed"`` goes without."""
    if cfg.qk_norm:
        t = rms_norm(t, p[which + "_norm"], cfg.norm_eps)
    if cfg.rope_layers == "all" or cfg.attn_kind in ("swa", "local"):
        t = apply_rope(t, positions, cfg.rope_theta)
    return t


def _gqa_scores(q, k, scale):
    """q: [B,qb,KV,G,hd]  k: [B,kb,KV,hd]  ->  [B,KV,G,qb,kb] (fp32)."""
    return torch.einsum("bqkgh,btkh->bkgqt", q.float(), k.float()) * scale


def attention_core(q, k, v, q_pos, k_pos, *, causal: bool = True,
                   window: int = 0, q_block: int = 512, kv_block: int = 1024,
                   kv_valid: Optional[torch.Tensor] = None):
    """Blocked attention with an online softmax over key blocks.

    q: [B,S,H,hd]; k,v: [B,T,KV,hd]; q_pos: [S] or [B,S]; k_pos: [T] or
    [B,T]; window > 0 also masks keys older than ``window`` positions;
    kv_valid: optional [B,T] bool mask of valid cache slots.
    Returns [B,S,H,hd] in q.dtype.  The loops over query and key blocks
    are the JAX package's double ``lax.scan``; probabilities are cast to
    v's dtype before the PV product, as there.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    scale = hd ** -0.5
    qb = min(q_block, S)
    kb = min(kv_block, T)
    dev = q.device
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :].expand(B, S)
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :].expand(B, T)
    if kv_valid is None:
        kv_valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    outs = []
    for q0 in range(0, S, qb):
        q_i = q[:, q0:q0 + qb]
        n = q_i.shape[1]
        q_i = q_i.reshape(B, n, KV, G, hd)
        qpos_i = q_pos[:, q0:q0 + qb]
        m = torch.full((B, KV, G, n), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, n), device=dev)
        acc = torch.zeros((B, KV, G, n, hd_v), device=dev)
        for t0 in range(0, T, kb):
            k_j, v_j = k[:, t0:t0 + kb], v[:, t0:t0 + kb]
            s = _gqa_scores(q_i, k_j, scale)                # [B,KV,G,n,kb]
            msk = kv_valid[:, None, None, None, t0:t0 + kb]
            kp = k_pos[:, None, None, None, t0:t0 + kb]
            qp = qpos_i[:, None, None, :, None]
            if causal:
                msk = msk & (kp <= qp)
            if window:
                msk = msk & (kp > qp - window)
            s = torch.where(msk, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            pr = torch.exp(s - m_new[..., None])
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", pr.to(v_j.dtype).float(), v_j.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # [B,KV,G,n,hd]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, n, H, hd_v))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Sliding-window attention: per-q-block KV slice (subquadratic)
# ---------------------------------------------------------------------------

def windowed_attention(q, k, v, q_pos, k_pos, *, window: int,
                       q_block: int = 512):
    """Causal sliding-window attention; each query block attends a KV slice
    of length ``window + q_block`` ending at the block's last position.

    Shapes as in attention_core.  Assumes q and k cover the same contiguous
    positions (train/prefill self-attention).  The JAX package pads the
    last query block (padded rows carry position -1 and are dropped); here
    it is simply shorter, which changes no real row.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qb = min(q_block, S)
    span = window + qb
    if span >= T:  # window covers everything — fall back
        return attention_core(q, k, v, q_pos, k_pos, causal=True,
                              window=window)
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :].expand(B, S)
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :].expand(B, T)
    neg = torch.full((), NEG_INF, device=q.device)
    outs = []
    for q0 in range(0, S, qb):
        q_i = q[:, q0:q0 + qb]
        n = q_i.shape[1]
        start = min(max(q0 + qb - span, 0), T - span)
        k_j, v_j = k[:, start:start + span], v[:, start:start + span]
        kp = k_pos[:, None, None, None, start:start + span]
        qp = q_pos[:, None, None, q0:q0 + qb, None]
        s = _gqa_scores(q_i.reshape(B, n, KV, G, hd), k_j, scale)
        msk = (kp <= qp) & (kp > qp - window)
        pr = torch.softmax(torch.where(msk, s, neg), dim=-1)
        out = torch.einsum("bkgqt,btkh->bkgqh", pr.to(v_j.dtype).float(),
                           v_j.float())
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, n, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode: ring-buffer KV cache (one private cache per sequence)
# ---------------------------------------------------------------------------

def init_cache(batch: int, cache_len: int, num_kv: int, head_dim: int, dtype,
               device):
    """Cache slots carry their absolute position (-1 = empty)."""
    return {
        "k": torch.zeros((batch, cache_len, num_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, num_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_positions(index, batch: int):
    """Positions [batch, 1] int32 of a decode step's tokens: a ring cache's
    next position ``index``, shared by the batch ([]) or per row
    ([batch]).  A copy: the step advances ``index`` in place."""
    return index.expand(batch)[:, None].to(torch.int32, copy=True)


def ring_append(cache, new):
    """Write one decode step into a ring cache, in place, and advance it.

    ``new`` maps leaf names to this step's rows [B, ...]; each row lands at
    ring slot ``index % L`` of its own row.  ``index`` ([] shared, or [B]
    per row) and ``pos`` ([L] shared, or [B, L] per row) follow the
    cache's form: per-row caches are the slotted pool's, whose slots stand
    at different positions, written by a per-row scatter with no host
    sync.  Returns the same dict."""
    first = cache[next(iter(new))]
    B, L = first.shape[:2]
    index = cache["index"]
    idx = index.expand(B)
    slot = (idx % L).long()
    rows = torch.arange(B, device=first.device)
    for name, t in new.items():
        cache[name][rows, slot] = t.to(cache[name].dtype)
    pos = cache["pos"]
    if pos.dim() == 1:
        pos[slot[:1]] = idx[:1].to(pos.dtype)
    else:
        pos[rows, slot] = idx.to(pos.dtype)
    index += 1
    return cache


def ring_valid(cache, window: int = 0):
    """[B or 1, L] bool: the cache slots a query at the newest position may
    attend (written, not in the future, inside the window)."""
    cur = (cache["index"] - 1).reshape(-1, 1)     # newest token's position
    kpos = cache["pos"]
    if kpos.dim() == 1:
        kpos = kpos[None]
    valid = (kpos >= 0) & (kpos <= cur)
    if window:
        valid &= kpos > cur - window
    return valid


def cache_update(cache, k_new, v_new):
    """Append one step (k_new/v_new: [B,1,KV,hd]) at ring slot index % len,
    in place (``ring_append``)."""
    return ring_append(cache, {"k": k_new[:, 0], "v": v_new[:, 0]})


def decode_attend(q, cache, *, window: int = 0):
    """q: [B,1,H,hd] against the cache. Returns [B,1,H,hd]."""
    B, _, H, hd = q.shape
    KV = cache["k"].shape[2]
    G = H // KV
    scale = hd ** -0.5
    valid = ring_valid(cache, window)             # [B or 1, L]
    q_ = q.reshape(B, 1, KV, G, hd)
    s = _gqa_scores(q_, cache["k"], scale)        # [B,KV,G,1,L]
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bkgqh",
                       pr.to(cache["v"].dtype).float(), cache["v"].float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV cache (global page pool shared by all slots)
#
# Page writes are in place: the JAX package donated the page buffers and
# returned new ones; here the pool's tensors are updated where they lie
# and the same dict is returned.
# ---------------------------------------------------------------------------

def _paged_window(cfg) -> int:
    """Ring-layout window of a GQA family (0 = contiguous pages)."""
    return cfg.window if cfg.attn_kind in ("swa", "local") else 0


def _write_rows(kv, name: str, page, off, rows) -> None:
    """Scatter K/V rows into one leaf's pages, in place; int8 pools (a
    ``*_scale`` leaf beside the data leaf) quantize the rows once here
    and scatter the int8 rows and their per-head scales alike."""
    # imported here: repro_torch.serving sits above the models
    from repro_torch.serving.layouts import SCALE_SUFFIX, quantize_kv
    if name + SCALE_SUFFIX in kv:
        qrows, srows = quantize_kv(rows)
        kv[name][page, off] = qrows
        kv[name + SCALE_SUFFIX][page, off] = srows
    else:
        kv[name][page, off] = rows.to(kv[name].dtype)


def paged_cache_update(kv, k_new, v_new, page_table, pos, *, window: int = 0):
    """Write one decode step's K/V into the shared page pool, in place.

    kv: {"k","v"[,"k_scale","v_scale"]}: [P, ps, KV(, hd)] (one layer's
    pages); k_new/v_new [slots, 1, KV, hd]; page_table [slots, n] int32;
    pos [slots] int32 — token t of slot s lands in page ``page_table[s, t
    // ps]`` at offset ``t % ps`` (contiguous), or — ring layout, ``window
    > 0`` — in cell ``(t % window) // ps`` of the slot's ring, same
    offset.  Slots without a request carry an all-trash table (page 0), so
    their writes clobber only the reserved trash page (duplicate targets
    there are harmless: nothing reads it).
    """
    ps = kv["k"].shape[1]
    pos = pos.long()
    idx = pos % window if window else pos
    page = torch.gather(page_table.long(), 1, (idx // ps)[:, None])[:, 0]
    off = pos % ps
    for name, new in (("k", k_new), ("v", v_new)):
        _write_rows(kv, name, page, off, new[:, 0])
    return kv


def _chunk_targets(page_ids, start: int, n_valid: int, S: int, ps: int,
                   window: int = 0):
    """(page, off) scatter targets for one prefill chunk of S bucket slots:
    token i holds absolute position ``start + i`` (ring layouts: cell
    ``(start + i) % window // ps``); bucket padding (i >= n_valid) routes
    to the reserved trash page 0 so the fixed bucket shape never scatters
    garbage into held pages.  A ring chunk longer than the window keeps
    only its last ``window`` tokens: the earlier ones would land on the
    same cells, and no later query reads them."""
    i = torch.arange(S, device=page_ids.device)
    pos = start + i
    idx = pos % window if window else pos
    blk = torch.clamp(idx // ps, 0, page_ids.shape[0] - 1)
    live = (i < n_valid) & (i >= n_valid - window) if window \
        else i < n_valid
    page = torch.where(live, page_ids.long()[blk], 0)
    return page, pos % ps


def paged_prefill_write(kv, k_new, v_new, page_ids, start: int,
                        n_valid: int, *, window: int = 0):
    """Write one prefill chunk's K/V into the shared page pool, in place.

    kv: one layer's pages; k_new/v_new [1, S, KV, hd] (S = padded bucket
    length); page_ids [n] int32 — one request's page-table row.  Position
    mapping per ``_chunk_targets`` (contiguous or ring); int8 pools
    quantize per ``_write_rows``.  Padding rows land in the trash page.
    """
    ps = kv["k"].shape[1]
    page, off = _chunk_targets(page_ids, start, n_valid, k_new.shape[1], ps,
                               window)
    for name, new in (("k", k_new), ("v", v_new)):
        _write_rows(kv, name, page, off, new[0])
    return kv


def paged_prefill_apply(cfg, p, x, positions, kv, page_ids, start: int,
                        n_valid: int, *, use_kernels: bool = False):
    """Prefill-chunk GQA self-attention directly against the page pool.

    x [1, S, D] — one request's chunk, padded to a bucket; positions =
    start + arange(S); page_ids [n] the request's page-table row.

    Contiguous layout: the chunk's K/V are written into the pool first
    (pages covering the cached prefix are never written: the chunk starts
    at ``start`` >= prefix length, and padding writes hit the trash page),
    then the chunk's queries attend causally over everything cached so far
    — shared prefix pages, earlier chunks and the chunk itself.

    Ring layout (sliding-window): the chunk's writes wrap onto cells its
    own early queries still need, so attention reads the ring as a
    snapshot BEFORE the write, with the chunk's own K/V as separate
    operands and ring-arithmetic key positions; the sliding-window mask
    keeps every overwritten snapshot cell out of the scores.  A chunk may
    be longer than the window: its queries then reach back only into its
    own keys, and only its last ``window`` keys are written.

    ``use_kernels`` runs the CUDA kernels (K2, K5); int8 pools go through
    the kernel family's ops even without them — the plain versions there
    apply the same fused dequant as the kernels, which keeps int8 kernel
    on and off token-identical.  Otherwise the plain path is the gathered
    ``attention_core``.  Returns (out [1, S, D], kv) — kv updated in place.
    """
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.serving.layouts import SCALE_SUFFIX
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = local_extent(cfg.num_heads, "heads")
    cd = x.dtype
    ps = kv["k"].shape[1]
    n = page_ids.shape[0]
    window = _paged_window(cfg)
    quantized = "k" + SCALE_SUFFIX in kv
    scales = dict(k_scale=kv.get("k" + SCALE_SUFFIX),
                  v_scale=kv.get("v" + SCALE_SUFFIX))
    q, k, v = _project_qkv_rope(cfg, p, x, positions)
    if window:
        if use_kernels or quantized:
            # snapshot semantics by construction: the ring is read before
            # the write, and the chunk's own K/V come as fp operands
            out = pa_ops.paged_ring_prefill(
                q[0], kv["k"], kv["v"], k[0].to(cd), v[0].to(cd), page_ids,
                start, n_valid, window=window, use_kernel=use_kernels,
                **scales)[None]
        else:
            table = page_ids.long()
            ring_k = kv["k"][table].reshape(1, n * ps, *k.shape[2:])
            ring_v = kv["v"][table].reshape(1, n * ps, *v.shape[2:])
            cur = start - 1
            i = torch.arange(n * ps, device=x.device)
            ring_pos = cur - torch.remainder(cur - i, window)  # < 0: unwritten
            kk = torch.cat([ring_k.to(cd), k], dim=1)
            vv = torch.cat([ring_v.to(cd), v], dim=1)
            j = torch.arange(S, device=x.device)
            k_pos = torch.cat([ring_pos, start + j])
            kv_valid = torch.cat([ring_pos >= 0, j < n_valid])[None, :]
            out = attention_core(q, kk, vv, positions, k_pos, causal=True,
                                 window=window, q_block=cfg.attn_q_block,
                                 kv_block=cfg.attn_kv_block,
                                 kv_valid=kv_valid)
        kv = paged_prefill_write(kv, k, v, page_ids, start, n_valid,
                                 window=window)
    else:
        kv = paged_prefill_write(kv, k, v, page_ids, start, n_valid)
        out = pa_ops.paged_prefill(q[0], kv["k"], kv["v"], page_ids, start,
                                   n_valid, use_kernel=use_kernels,
                                   **scales)[None]
    out = out.reshape(B, S, H * hd)
    return _out_proj(p, out, cd), kv


def paged_attention_apply(cfg, p, x, positions, kv, page_table, lengths, *,
                          use_kernels: bool = False):
    """One batched decode step of GQA self-attention over a paged pool.

    x [slots, 1, D]; positions [slots, 1] (= lengths[:, None]); kv one
    layer's pages.  The whole slot batch runs against the shared pool:
    write this step's K/V (quantized on int8 pools), then attend through
    the decode kernel (``use_kernels``: K1, or K4 on ring pages) or its
    plain version — the ring's position mapping and window mask, and the
    int8 dequant, live there.  Returns (out [slots, 1, D], kv) — kv
    updated in place.
    """
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.serving.layouts import SCALE_SUFFIX
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = local_extent(cfg.num_heads, "heads")
    cd = x.dtype
    window = _paged_window(cfg)
    q, k, v = _project_qkv_rope(cfg, p, x, positions)
    kv = paged_cache_update(kv, k, v, page_table, lengths, window=window)
    out = pa_ops.paged_attention(q[:, 0], kv["k"], kv["v"], page_table,
                                 (lengths + 1).to(torch.int32),
                                 window=window,
                                 k_scale=kv.get("k" + SCALE_SUFFIX),
                                 v_scale=kv.get("v" + SCALE_SUFFIX),
                                 use_kernel=use_kernels)
    out = out[:, None].reshape(B, S, H * hd)
    return _out_proj(p, out, cd), kv


# ---------------------------------------------------------------------------
# Full GQA block apply (projections + rope + core/decode dispatch)
# ---------------------------------------------------------------------------

def attention_apply(cfg, p, x, positions, *, cache=None,
                    use_kernels: bool = False):
    """Self-attention for train/prefill (cache=None) or one decode step
    against a ring cache (written in place).  Returns (out [B,S,D],
    cache_or_None).

    The train/prefill core is chosen as the JAX package chooses it: the
    flash-attention autograd Function with kernel K3 in its forward
    (``use_kernels``; on a CPU tensor its forward is the plain ``_fwd``),
    else the O(S)-residual ``flash_attention_vjp`` (``cfg.attn_remat``),
    else ``windowed_attention`` for a windowed family longer than twice its
    window, else the blocked ``attention_core``.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = local_extent(cfg.num_heads, "heads")
    cd = x.dtype
    q, k, v = _project_qkv_rope(cfg, p, x, positions)
    window = cfg.window if cfg.attn_kind in ("swa", "local") else 0
    if cache is None:
        if use_kernels or cfg.attn_remat:
            out = flash_attention_vjp(
                q, k, v, causal=True, window=window,
                q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
                use_kernel=use_kernels)
        elif window and S > 2 * window:
            out = windowed_attention(q, k, v, positions, positions,
                                     window=window, q_block=cfg.attn_q_block)
        else:
            out = attention_core(q, k, v, positions, positions, causal=True,
                                 window=window, q_block=cfg.attn_q_block,
                                 kv_block=cfg.attn_kv_block)
        new_cache = None
    else:
        new_cache = cache_update(cache, k, v)
        out = decode_attend(q, new_cache, window=window)
    out = out.reshape(B, S, H * hd)
    return _out_proj(p, out, cd), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed latent cache, expanded for train/prefill,
# absorbed projections for decode
# ---------------------------------------------------------------------------

def mla_init_cache(batch: int, cache_len: int, cfg, dtype, device):
    """Ring cache of the latents (slots carry their position, -1 = empty)."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, cache_len, m.qk_rope_head_dim),
                             dtype=dtype, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_latents(cfg, p, x, positions):
    """The cached latents of x [B,S,D]: the rms-normed compressed kv
    ``ckv`` [B,S,R] and the roped shared key ``krope`` [B,S,rp] (roped with
    its own singleton head axis)."""
    m = cfg.mla
    dkv = dot(x, p["w_dkv"], x.dtype)                       # [B,S,rank+rope]
    ckv, krope = torch.split(dkv, [m.kv_lora_rank, m.qk_rope_head_dim],
                             dim=-1)
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    krope = apply_rope(krope[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]
    return ckv, krope


def _mla_q(cfg, p, x, positions, cd):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rp] roped)."""
    m = cfg.mla
    H = local_extent(cfg.num_heads, "heads")
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        cq = rms_norm(dot(x, p["w_dq"], cd), p["q_norm"], cfg.norm_eps)
        q = dot(cq, p["w_uq"], cd)
    else:
        q = dot(x, p["wq"], cd)
    q = q.reshape(*x.shape[:2], H, qk_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_scale(cfg) -> float:
    """The qk-dimension softmax scale (not the latent rank's)."""
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _absorb_q(cfg, p, q_nope, cd):
    """Latent-space queries q' = q_nope @ W_uk^T [..., H, R]: fp32
    products of the compute-dtype operands, cast to the compute dtype."""
    m = cfg.mla
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, -1,
                             m.qk_nope_head_dim).to(cd)
    return torch.einsum("bshn,rhn->bshr", q_nope.float(),
                        w_uk.float()).to(cd)


def _up_v(cfg, p, o_lat, cd):
    """Latent output o_lat [..., H, R] (compute dtype) through W_uv ->
    [..., H, v_head_dim] in the compute dtype (fp32 products)."""
    m = cfg.mla
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, -1,
                             m.v_head_dim).to(cd)
    return torch.einsum("...hr,rhv->...hv", o_lat.to(cd).float(),
                        w_uv.float()).to(cd)


def _mla_expanded(cfg, p, q_nope, q_rope, ckv, krope, q_pos, k_pos, *,
                  kv_valid=None):
    """Expanded MLA attention: per-head K/V materialized from the latents
    ckv [B,T,R] / krope [B,T,rp], causal over q_pos / k_pos.  Returns
    [B,S,H,v_head_dim]."""
    m = cfg.mla
    B, T, _ = ckv.shape
    H = local_extent(cfg.num_heads, "heads")
    cd = q_nope.dtype
    k_nope = dot(ckv, p["w_uk"], cd).reshape(B, T, H, m.qk_nope_head_dim)
    vv = dot(ckv, p["w_uv"], cd).reshape(B, T, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        B, T, H, m.qk_rope_head_dim).to(cd)], dim=-1)
    return attention_core(q, k, vv, q_pos, k_pos, causal=True,
                          q_block=cfg.attn_q_block,
                          kv_block=cfg.attn_kv_block, kv_valid=kv_valid)


def mla_apply(cfg, p, x, positions, *, cache=None):
    """MLA for train/prefill (cache=None: expanded path) or one decode step
    against a latent ring cache (absorbed path; the cache is written in
    place).  Returns (out [B,S,D], cache_or_None)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = local_extent(cfg.num_heads, "heads")
    cd = x.dtype
    ckv, krope = mla_latents(cfg, p, x, positions)
    q_nope, q_rope = _mla_q(cfg, p, to_model(x, "heads"), positions, cd)

    if cache is None:
        # the latents are replicated; each rank's heads read them
        out = _mla_expanded(cfg, p, q_nope, q_rope, to_model(ckv, "heads"),
                            to_model(krope, "heads"), positions, positions)
        out = out.reshape(B, S, H * m.v_head_dim)
        return _out_proj(p, out, cd), None

    # absorbed decode: score in the latent space (cache stays compressed)
    new_cache = ring_append(cache, {"ckv": ckv[:, 0], "krope": krope[:, 0]})
    valid = ring_valid(new_cache)                           # [B or 1, L]
    q_lat = _absorb_q(cfg, p, q_nope, cd)                   # [B,1,H,R]
    s = torch.einsum("bshr,btr->bhst", q_lat.float(),
                     new_cache["ckv"].float())
    s = s + torch.einsum("bshn,btn->bhst", q_rope.float(),
                         new_cache["krope"].float())
    s = torch.where(valid[:, None, None, :], s * _mla_scale(cfg),
                    torch.full((), NEG_INF, device=x.device))
    pr = torch.softmax(s, dim=-1)
    # output in the latent space, then up-projected through W_uv
    o_lat = torch.einsum("bhst,btr->bshr", pr.to(cd).float(),
                         new_cache["ckv"].float()).to(cd)
    out = _up_v(cfg, p, o_lat, cd).reshape(B, 1, H * m.v_head_dim)
    return _out_proj(p, out, cd), new_cache


def paged_latent_update(kv, ckv_new, krope_new, page_table, pos):
    """Latent-layout twin of ``paged_cache_update``, in place: kv {"ckv":
    [P, ps, R], "krope": [P, ps, rp]}; ckv_new/krope_new [slots, 1, ·]
    (MLA decode caches the compressed latents, never materialized heads)."""
    ps = kv["ckv"].shape[1]
    pos = pos.long()
    page = torch.gather(page_table.long(), 1, (pos // ps)[:, None])[:, 0]
    off = pos % ps
    for name, new in (("ckv", ckv_new), ("krope", krope_new)):
        kv[name][page, off] = new[:, 0].to(kv[name].dtype)
    return kv


def paged_latent_prefill_write(kv, ckv_new, krope_new, page_ids,
                               start: int, n_valid: int):
    """Latent-layout twin of ``paged_prefill_write``, in place: ckv_new
    [1, S, R], krope_new [1, S, rp] into {"ckv", "krope"} pages; padding
    rows land in the trash page."""
    ps = kv["ckv"].shape[1]
    page, off = _chunk_targets(page_ids, start, n_valid, ckv_new.shape[1],
                               ps)
    for name, new in (("ckv", ckv_new), ("krope", krope_new)):
        kv[name][page, off] = new[0].to(kv[name].dtype)
    return kv


def paged_mla_attention_apply(cfg, p, x, positions, kv, page_table, lengths,
                              *, use_kernels: bool = False):
    """One batched decode step of absorbed MLA over latent pages.

    x [slots, 1, D]; kv {"ckv": [P, ps, R], "krope": [P, ps, rp]} — one
    layer's latent pages.  The math mirrors ``mla_apply``'s decode path
    (scores in the latent space; the cache stays compressed); the storage
    is the shared page pool.  Attention runs through kernel K6
    (``use_kernels``) or its plain version over ``lengths + 1`` keys (this
    step's latents are written first).  Returns (out [slots, 1, D], kv) —
    kv updated in place."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    m = cfg.mla
    B, S, _ = x.shape
    H = local_extent(cfg.num_heads, "heads")
    cd = x.dtype
    ckv, krope = mla_latents(cfg, p, x, positions)
    q_nope, q_rope = _mla_q(cfg, p, x, positions, cd)
    kv = paged_latent_update(kv, ckv, krope, page_table, lengths)
    q_lat = _absorb_q(cfg, p, q_nope, cd)
    o_lat = pa_ops.paged_mla_attention(
        q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(), kv["ckv"],
        kv["krope"], page_table, (lengths + 1).to(torch.int32),
        scale=_mla_scale(cfg), use_kernel=use_kernels)
    out = _up_v(cfg, p, o_lat[:, None], cd).reshape(B, S, H * m.v_head_dim)
    return _out_proj(p, out, cd), kv


def paged_mla_prefill_apply(cfg, p, x, positions, kv, page_ids, start: int,
                            n_valid: int, *, use_kernels: bool = False):
    """Prefill-chunk MLA attention directly against latent pages.

    The chunk's latents are written into the pool.  Without
    ``use_kernels`` the chunk then attends the JAX package's default way —
    the slotted prefill's numerics (``mla_apply``'s *expanded* path): per-
    head K/V materialized from the gathered latents, causal over prefix +
    chunk.  With ``use_kernels`` it runs absorbed through kernel K7
    (``paged_mla_prefill``: queries absorbed through W_uk, pages read as
    compressed ckv/krope, the latent output up-projected through W_uv —
    the decode path's math), or through K7's plain version on the CPU.
    Returns (out [1, S, D], kv) — kv updated in place."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    m = cfg.mla
    B, S, _ = x.shape
    H = local_extent(cfg.num_heads, "heads")
    cd = x.dtype
    ps = kv["ckv"].shape[1]
    n = page_ids.shape[0]
    ckv, krope = mla_latents(cfg, p, x, positions)
    kv = paged_latent_prefill_write(kv, ckv, krope, page_ids, start, n_valid)
    q_nope, q_rope = _mla_q(cfg, p, x, positions, cd)
    if use_kernels:
        q_lat = _absorb_q(cfg, p, q_nope, cd)
        o_lat = pa_ops.paged_mla_prefill(
            q_lat[0].contiguous(), q_rope[0].contiguous(), kv["ckv"],
            kv["krope"], page_ids, start, n_valid, scale=_mla_scale(cfg),
            use_kernel=True)
        out = _up_v(cfg, p, o_lat, cd)[None]
    else:
        table = page_ids.long()
        ckv_all = kv["ckv"][table].reshape(1, n * ps, m.kv_lora_rank).to(cd)
        kr_all = kv["krope"][table].reshape(1, n * ps,
                                            m.qk_rope_head_dim).to(cd)
        k_pos = torch.arange(n * ps, device=x.device)
        out = _mla_expanded(cfg, p, q_nope, q_rope, ckv_all, kr_all,
                            positions, k_pos,
                            kv_valid=(k_pos < start + n_valid)[None, :])
    out = out.reshape(B, S, H * m.v_head_dim)
    return _out_proj(p, out, cd), kv
