"""Decoder-only LM assembly: embeddings + stacked layers + head.

Covers the dense (GQA) and MoE families, with full causal, sliding-
window (``mixtral``: swa + MoE) or MLA attention (``deepseek-v2-lite``:
MLA + MoE).

Entry points (the JAX package's, same names and contracts):
  * ``lm_loss``         — tokens -> scalar loss
  * ``lm_prefill``      — tokens -> last-token logits + ring caches (the
    slotted pool's whole-prompt prefill)
  * ``lm_decode``       — 1 token + ring caches -> logits (the slotted
    pool's decode, slots at their own positions)
  * ``lm_paged_prefill`` / ``lm_paged_verify`` / ``lm_paged_decode`` — the
    serving engine's paged paths against the shared page pool

Parameters keep the JAX pytree layout: ``params["layers"]`` holds stacked
``[L, ...]`` leaves, and the scan over layers is a Python loop over their
slices (views — no copy).  Page pools are ``{"k", "v"}: [L, P, ps, KV,
hd]`` tensors (MLA: ``{"ckv", "krope"}: [L, P, ps, R | rp]``) written in
place, as are ring caches; int8 pools add ``{"k_scale", "v_scale"}:
[L, P, ps, KV]`` bf16 leaves, and sliding-window families' pages form a
ring per slot (``serving/layouts.py``).

``use_kernels`` on ``lm_forward`` / ``lm_loss`` / ``lm_prefill`` runs every
layer's attention through kernel K3 (the JAX package's ``use_pallas``);
``cfg.remat`` checkpoints each layer as the JAX scan does.

Under a ``models.common.model_axis`` context every entry point runs on
this rank's shards (attention, MLP and MoE place their collectives), the
caches hold the local KV heads, and the head gathers vocab-sharded logits.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ParamSpec, apply_norm, cast_tree, dot,
                                       gather_model, norm_specs, stack_len,
                                       stack_specs, to_model, torch_dtype)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def embed_specs(cfg):
    return ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab_table", "embed"),
                     init="embed")


def head_specs(cfg):
    return ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))


def decoder_layer_specs(cfg):
    a = attn.mla_specs(cfg) if cfg.attn_kind == "mla" \
        else attn.attention_specs(cfg)
    ff = moe_mod.moe_specs(cfg) if cfg.moe is not None \
        else mlp_mod.mlp_specs(cfg)
    return {"ln1": norm_specs(cfg), "attn": a, "ln2": norm_specs(cfg),
            "ff": ff}


def layer_cfg(cfg, i: int):
    """Layer ``i``'s configuration: ``cfg`` itself in a stack of one kind;
    a global layer of a ``layer_pattern`` attends fully (``attn_kind``
    "full", no window), and a leading dense layer has no MoE and its own
    ``d_ff_dense``."""
    if not (cfg.layer_pattern or cfg.first_dense_layers):
        return cfg
    return _layer_cfg(cfg, i)


@functools.lru_cache(maxsize=None)
def _layer_cfg(cfg, i: int):
    kw = {}
    if cfg.layer_kind(i) == "G":
        kw.update(attn_kind="full", window=0)
    if i < cfg.first_dense_layers:
        kw.update(moe=None, d_ff=cfg.d_ff_dense or cfg.d_ff)
    return cfg.replace(**kw) if kw else cfg


def lm_specs(cfg):
    """Stacked leaves per group of equally shaped layers: ``layers``, and
    ``dense_layers`` for leading dense layers of another width.  Windowed
    and global layers share one stack (their weights have equal shapes)."""
    nd = cfg.first_dense_layers
    specs = {
        "embed": embed_specs(cfg),
        "layers": stack_specs(decoder_layer_specs(layer_cfg(cfg, nd)),
                              cfg.num_layers - nd),
        "final_norm": norm_specs(cfg),
    }
    if nd:
        specs["dense_layers"] = stack_specs(
            decoder_layer_specs(layer_cfg(cfg, 0)), nd)
    if not cfg.tie_embeddings:
        specs["lm_head"] = head_specs(cfg)
    return specs


def layer_params(params, i: int):
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]`` leaves
    (the leading dense layers' stack first, where there is one)."""
    def sl(t, j):
        if isinstance(t, dict):
            return {k: sl(v, j) for k, v in t.items()}
        return t[j]
    dense = params.get("dense_layers")
    if dense is not None:
        nd = stack_len(dense)
        if i < nd:
            return sl(dense, i)
        i -= nd
    return sl(params["layers"], i)


def _layer_pages(pages, i: int):
    """Layer ``i``'s page pool: views, so kernels and in-place writes reach
    the shared [L, P, ps, KV, hd] tensors."""
    return {k: v[i] for k, v in pages.items()}


@functools.lru_cache(maxsize=None)
def _kind_index(cfg, i: int) -> int:
    """Layer ``i``'s place among the layers of its own kind."""
    return sum(cfg.layer_kind(j) == cfg.layer_kind(i) for j in range(i))


def _layer_kv(cfg, state, i: int):
    """(layer ``i``'s pages, its page table) of a paged ``state``.  A
    two-kind pool (``ring_table`` in the state) holds the global layers'
    contiguous pages under ``k`` / ``v`` and the windowed layers' ring
    cells under ``ring_k`` / ``ring_v``, each stack in layer order."""
    pages = state["pages"]
    if "ring_table" not in state:
        return _layer_pages(pages, i), state["page_table"]
    j = _kind_index(cfg, i)
    if cfg.layer_kind(i) == "G":
        return {"k": pages["k"][j], "v": pages["v"][j]}, state["page_table"]
    return ({"k": pages["ring_k"][j], "v": pages["ring_v"][j]},
            state["ring_table"])


# ---------------------------------------------------------------------------
# Layer apply
# ---------------------------------------------------------------------------

def ff_apply(cfg, p, h, *, n_valid=None, per_token: bool = False,
             dense: bool = False):
    """The feed-forward half: (out, aux) — MoE (``moe_apply``'s routing
    modes and aux loss; ``dense``: its sync-free decode route) or the
    dense MLP (aux 0)."""
    if cfg.moe is not None:
        return moe_mod.moe_apply(cfg, p, h, n_valid=n_valid,
                                 per_token=per_token, dense=dense)
    return mlp_mod.mlp_apply(cfg, p, h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def sub_in(cfg, p_norm, x):
    """A sublayer's input: the normed residual ("pre") or the residual
    itself ("post": the norm comes after the sublayer)."""
    return x if cfg.norm_placement == "post" else apply_norm(cfg, p_norm, x)


def sub_out(cfg, p_norm, y):
    """What a sublayer adds to the residual: its output, normed when the
    norm comes after it ("post")."""
    return apply_norm(cfg, p_norm, y) if cfg.norm_placement == "post" else y


def decoder_layer_apply(cfg, p, x, positions, cache=None,
                        use_kernels=False, per_token: bool = False,
                        dense: bool = False):
    """Returns (x, new_cache, aux); ``cfg`` is the layer's own
    (``layer_cfg``).  MLA attention ignores ``use_kernels``
    here, as the JAX package's does ``use_pallas``: its whole-sequence
    path is the expanded one.  ``per_token`` routes MoE drop-free per
    token (``moe_apply``), on its dense route with ``dense``."""
    h = sub_in(cfg, p["ln1"], x)
    if cfg.attn_kind == "mla":
        a, new_cache = attn.mla_apply(cfg, p["attn"], h, positions,
                                      cache=cache)
    else:
        a, new_cache = attn.attention_apply(cfg, p["attn"], h, positions,
                                            cache=cache,
                                            use_kernels=use_kernels)
    x = x + sub_out(cfg, p["ln1"], a)
    f, aux = ff_apply(cfg, p["ff"], sub_in(cfg, p["ln2"], x),
                      per_token=per_token, dense=dense)
    return x + sub_out(cfg, p["ln2"], f), new_cache, aux


def _train_layer(cfg, positions, use_kernels, p, x):
    """(x, aux) of one layer on the whole sequence (``cfg`` bound per
    layer, so a recompute in the backward runs the same layer)."""
    x, _, aux = decoder_layer_apply(cfg, p, x, positions,
                                    use_kernels=use_kernels)
    return x, aux


#: matmuls without batch dims: what the "dots" policy keeps (the JAX
#: package's ``dots_with_no_batch_dims_saveable``); everything else is
#: recomputed in the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """Activation checkpointing of one layer per ``cfg.remat``: "none"
    saves everything, "full" recomputes the layer in the backward, "dots"
    saves only the weight matmuls' outputs.  Values never change; without
    grad mode the layer just runs."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_lookup(cfg, params, tokens, compute_dtype):
    x = params["embed"][tokens.long()].to(compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    return x


def lm_head(cfg, params, x):
    """Logits over the whole vocabulary: an untied head shards the vocab
    over the model axis (column-parallel), and its logits are gathered
    before argmax, sampling or the loss — every rank then holds the same
    logits, so first-index ties break as on one device."""
    if cfg.tie_embeddings:
        return dot(x, params["embed"].T, x.dtype)
    logits = dot(to_model(x, "vocab"), params["lm_head"], x.dtype)
    return gather_model(logits, "vocab")


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def lm_forward(cfg, params, tokens, *, collect_cache: bool = False,
               cache_len: int = 0, n_valid=None, use_kernels: bool = False,
               moe_dropless: bool = False):
    """tokens [B,S] -> (final-normed hidden [B,S,d], caches_or_None, aux).

    ``n_valid`` (cache-collection path only) marks a masked bucket tail:
    tokens at positions >= n_valid are padding — their cache slots carry
    pos = -1 and the cache index is n_valid.  ``aux`` is the MoE auxiliary
    loss summed over layers (0 for the dense family).  ``moe_dropless``
    (cache-collection path) routes MoE per token with no capacity
    truncation — the serving engine's routing; training keeps GShard
    capacity semantics.
    """
    x = embed_lookup(cfg, params, tokens, torch_dtype(cfg.compute_dtype))
    return layers_forward(cfg, params, x, collect_cache=collect_cache,
                          cache_len=cache_len, n_valid=n_valid,
                          use_kernels=use_kernels, moe_dropless=moe_dropless)


def layers_forward(cfg, params, x, *, collect_cache: bool = False,
                   cache_len: int = 0, n_valid=None, use_kernels: bool = False,
                   moe_dropless: bool = False):
    """``lm_forward`` from the input embeddings x [B,S,d] on (pixtral
    prepends its image patches to the token embeddings)."""
    cd = x.dtype
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    kv, hd = attn.local_heads(cfg)[1], cfg.resolved_head_dim
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i in range(cfg.num_layers):
        lcfg = layer_cfg(cfg, i)
        lp = layer_params(params, i)
        if not collect_cache:
            x, a2 = _remat(cfg, functools.partial(
                _train_layer, lcfg, positions, use_kernels))(lp, x)
            aux = aux + a2
            continue
        h = sub_in(lcfg, lp["ln1"], x)
        if cfg.attn_kind == "mla":
            # expanded attention; the cache keeps the latents
            a, _ = attn.mla_apply(cfg, lp["attn"], h, positions)
            ckv, krope = attn.mla_latents(cfg, lp["attn"], h, positions)
            leaves = {"ckv": ckv, "krope": krope}
        else:
            a, _ = attn.attention_apply(lcfg, lp["attn"], h, positions,
                                        use_kernels=use_kernels)
            # project k/v once more for the cache (cheap next to
            # attention; keeps attention_apply pure), as the JAX package
            # does
            k = dot(h, lp["attn"]["wk"], cd)
            v = dot(h, lp["attn"]["wv"], cd)
            if cfg.qkv_bias:
                k = k + lp["attn"]["bk"].to(cd)
                v = v + lp["attn"]["bv"].to(cd)
            k = attn.norm_rope(lcfg, lp["attn"], k.reshape(B, S, kv, hd),
                               positions, "k")
            leaves = {"k": k, "v": v.reshape(B, S, kv, hd)}
        caches.append(_fill_cache(leaves, positions, cache_len, n_valid))
        x = x + sub_out(lcfg, lp["ln1"], a)
        # bucketed serving prefill: padding must not consume expert
        # capacity, and serving routes drop-free per token
        f, a2 = ff_apply(lcfg, lp["ff"], sub_in(lcfg, lp["ln2"], x),
                         n_valid=n_valid, per_token=moe_dropless)
        x = x + sub_out(lcfg, lp["ln2"], f)
        aux = aux + a2
    x = apply_norm(cfg, params["final_norm"], x)
    if not collect_cache:
        return x, None, aux
    stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    return x, stacked, aux


def _fill_cache(leaves, positions, cache_len: int, n_valid=None):
    """Build a ring cache from prefill tensors ``leaves`` (``{"k", "v"}``
    [B,S,KV,hd] or MLA's ``{"ckv", "krope"}`` [B,S,·]), keeping the last
    cache_len tokens.

    With ``n_valid`` (masked bucket tail; requires S <= cache_len) padding
    entries carry pos = -1 and ``index`` = n_valid.
    """
    first = next(iter(leaves.values()))
    B, S = first.shape[:2]
    dev = first.device
    L = min(cache_len, S) if cache_len else S
    Lc = cache_len or S
    pos = positions[S - L:].long()
    slots = pos % Lc
    out = {}
    for name, t in leaves.items():
        c = torch.zeros((B, Lc) + tuple(t.shape[2:]), dtype=t.dtype,
                        device=dev)
        c[:, slots] = t[:, S - L:]
        out[name] = c
    cpos = torch.full((Lc,), -1, dtype=torch.int32, device=dev)
    if n_valid is None:
        cpos[slots] = pos.to(torch.int32)
        index = torch.tensor(S, dtype=torch.int32, device=dev)
    else:
        cpos[slots] = torch.where(pos < n_valid, pos, -1).to(torch.int32)
        index = torch.tensor(int(n_valid), dtype=torch.int32, device=dev)
    return {**out, "pos": cpos, "index": index}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, vocab: int):
    """Mean token cross-entropy in fp32 (labels == -100 are masked)."""
    logits = logits.float()
    mask = labels >= 0
    labels = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def lm_loss(cfg, params, batch, *, use_kernels: bool = False):
    """batch: {"tokens": [B,S], "labels": [B,S]} -> scalar fp32 loss."""
    params = cast_tree(params, cfg.compute_dtype)
    x, _, aux = lm_forward(cfg, params, batch["tokens"],
                           use_kernels=use_kernels)
    logits = lm_head(cfg, params, x)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss


def lm_prefill(cfg, params, tokens, *, cache_len: int = 0, n_valid=None,
               use_kernels: bool = False, moe_dropless: bool = False):
    """tokens [B,S] -> (last_logits [B,V], caches).  With ``n_valid``, S is
    a padded bucket and the logits are the n_valid-th token's.
    ``moe_dropless`` selects the serving engine's per-token MoE routing
    (see ``lm_forward``)."""
    params = cast_tree(params, cfg.compute_dtype)
    x, caches, _ = lm_forward(cfg, params, tokens, collect_cache=True,
                              cache_len=cache_len or tokens.shape[1],
                              n_valid=n_valid, use_kernels=use_kernels,
                              moe_dropless=moe_dropless)
    last = x[:, -1:] if n_valid is None else \
        x[:, int(n_valid) - 1:int(n_valid)]
    logits = lm_head(cfg, params, last)
    return logits[:, 0], caches


def lm_paged_prefill(cfg, params, tokens, state, *, use_kernels: bool = False):
    """Prefill one request's (suffix) chunk straight into the paged pool.

    tokens [1, S] — S is a padded bucket; state:
      * ``pages``      {"k","v"}: [L, P, ps, KV, hd] — global page pool
      * ``page_table`` [n] int32 — this request's page-table row
      * ``start``      int — tokens already cached (shared prefix pages +
        earlier chunks); the chunk holds positions start..start+S-1
      * ``n_valid``    int — real tokens in the chunk (the bucket tail past
        it is masked and written to the trash page)

    Returns (logits [1, V] of the last valid token, pages) — pages written
    in place.  ``use_kernels`` selects the CUDA chunked-prefill kernel (K2
    on contiguous pages, K5 on a sliding-window family's ring pages, K7 on
    MLA's latent pages).  Int8 pools carry ``k_scale`` / ``v_scale``
    leaves beside ``k`` / ``v``; each layer's pages reach the attention
    with them (quantize on write, dequant fused into the attention).
    """
    x, n_valid, pages = _paged_forward(cfg, params, tokens, state,
                                       use_kernels=use_kernels)
    logits = lm_head(cfg, params, x[:, n_valid - 1:n_valid])
    return logits[:, 0], pages


def lm_paged_verify(cfg, params, tokens, state, *, use_kernels: bool = False):
    """Speculative-decode verify forward: the drafted span runs through the
    paged-prefill scatter, and the head runs over every position — logits
    [S, V], row ``j`` predicting sequence index ``start + 1 + j``."""
    x, _, pages = _paged_forward(cfg, params, tokens, state,
                                 use_kernels=use_kernels)
    return lm_head(cfg, params, x)[0], pages


def _paged_forward(cfg, params, tokens, state, *, use_kernels: bool = False):
    """Shared paged prefill/verify body -> (x [1,S,d], n_valid, pages).
    MoE routes per token with the bucket tail masked."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    S = tokens.shape[1]
    start, n_valid = int(state["start"]), int(state["n_valid"])
    positions = start + torch.arange(S, dtype=torch.int32,
                                     device=tokens.device)
    x = embed_lookup(cfg, params, tokens, cd)
    pages = state["pages"]
    for i in range(cfg.num_layers):
        lcfg = layer_cfg(cfg, i)
        lp = layer_params(params, i)
        h = sub_in(lcfg, lp["ln1"], x)
        apply = attn.paged_mla_prefill_apply if cfg.attn_kind == "mla" \
            else attn.paged_prefill_apply
        kv, table = _layer_kv(cfg, state, i)
        a, _ = apply(lcfg, lp["attn"], h, positions, kv, table, start,
                     n_valid, use_kernels=use_kernels)
        x = x + sub_out(lcfg, lp["ln1"], a)
        f, _ = ff_apply(lcfg, lp["ff"], sub_in(lcfg, lp["ln2"], x),
                        n_valid=n_valid, per_token=True)
        x = x + sub_out(lcfg, lp["ln2"], f)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, n_valid, pages


def lm_decode(cfg, params, tokens, caches):
    """One decode step. tokens [B,1]; caches stacked [L,...] ring caches,
    written in place.  Their position is shared by the batch (``pos [L,
    Lc]``, ``index [L]``: what ``lm_prefill`` returns) or kept per row
    (``pos [L, B, Lc]``, ``index [L, B]``: the slotted pool's slots, each
    at its own position — the JAX engine's ``vmap`` over slots written
    out as a batch axis).

    MoE routes per token on per-row caches: the slots are independent
    sequences, which the JAX engine decodes one token each (its ``vmap``),
    where GShard capacity never drops a token — routing the slot batch
    through one capacity group would let slots displace each other.  It
    takes the dense route there (no host sync: the engine captures this
    step in a CUDA graph).

    Returns (logits [B,V], caches)."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    positions = attn.decode_positions(caches["index"][0], tokens.shape[0])
    per_row = caches["index"].dim() > 1
    x = embed_lookup(cfg, params, tokens, cd)
    for i in range(cfg.num_layers):
        cache = {k: v[i] for k, v in caches.items()}
        x, _, _ = decoder_layer_apply(layer_cfg(cfg, i),
                                      layer_params(params, i), x,
                                      positions, cache=cache,
                                      per_token=per_row, dense=per_row)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params, x)
    return logits[:, 0], caches


def paged_decoder_layer_apply(cfg, p, x, positions, kv, page_table, lengths,
                              use_kernels=False):
    """Decode-step layer over a shared paged KV pool.  Returns (x, kv).

    Dispatches on the family's page layout: per-head k/v pages
    (``paged_attention_apply``) or MLA's latent ckv/krope pages
    (``paged_mla_attention_apply``); MoE routes per token, so concurrently
    decoding slots never compete for expert capacity, on the dense route
    (no host sync: the engine captures this step in a CUDA graph)."""
    h = sub_in(cfg, p["ln1"], x)
    apply = attn.paged_mla_attention_apply if cfg.attn_kind == "mla" \
        else attn.paged_attention_apply
    a, kv = apply(cfg, p["attn"], h, positions, kv, page_table, lengths,
                  use_kernels=use_kernels)
    x = x + sub_out(cfg, p["ln1"], a)
    f, _ = ff_apply(cfg, p["ff"], sub_in(cfg, p["ln2"], x),
                    per_token=True, dense=True)
    return x + sub_out(cfg, p["ln2"], f), kv


def lm_paged_decode(cfg, params, tokens, state, *, use_kernels: bool = False):
    """One decode step for *all* serving slots against a paged KV pool.

    tokens [slots, 1]; state:
      * ``pages``      {"k","v"}: [L, P, ps, KV, hd] — global page pool
      * ``page_table`` [slots, n] int32 — per-slot page ids (0 = trash)
      * ``pos``        [slots] int32 — tokens already cached per slot
        (= the position this step's token is written at)

    Returns (logits [slots, V], pages) — pages written in place.
    ``use_kernels`` selects the CUDA paged decode kernel (K1 on contiguous
    pages, K4 on ring pages, K6 on MLA's latent pages); int8 pools' scale
    leaves travel with their pages, as in ``lm_paged_prefill``.
    """
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    lengths = state["pos"]
    positions = lengths[:, None]
    x = embed_lookup(cfg, params, tokens, cd)
    pages = state["pages"]
    for i in range(cfg.num_layers):
        kv, table = _layer_kv(cfg, state, i)
        x, _ = paged_decoder_layer_apply(
            layer_cfg(cfg, i), layer_params(params, i), x, positions, kv,
            table, lengths, use_kernels=use_kernels)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params, x)
    return logits[:, 0], pages


def decode_cache_len(cfg, seq_len: int) -> int:
    """Ring-buffer length: bounded by the attention window when every
    layer is windowed (a ``layer_pattern`` with global layers keeps the
    whole sequence, and its windowed layers mask by position)."""
    if cfg.attn_kind in ("swa", "local") and cfg.window \
            and "G" not in cfg.layer_pattern:
        return min(seq_len, cfg.window)
    return seq_len


def init_decode_caches(cfg, batch: int, seq_len: int, device="cpu"):
    """Stacked [L,...] cache tree for lm_decode (MLA: the latent leaves
    ``ckv`` / ``krope``); windowed families' rings hold at most
    ``window`` positions."""
    cd = torch_dtype(cfg.compute_dtype)
    Lc = decode_cache_len(cfg, seq_len)
    if cfg.attn_kind == "mla":
        one = attn.mla_init_cache(batch, Lc, cfg, cd, device)
    else:
        one = attn.init_cache(batch, Lc, attn.local_heads(cfg)[1],
                              cfg.resolved_head_dim, cd, device)
    return {k: v[None].expand((cfg.num_layers,) + v.shape).clone()
            for k, v in one.items()}
