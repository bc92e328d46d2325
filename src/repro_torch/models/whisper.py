"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

The port of ``src/repro/models/whisper.py``: precomputed frame embeddings
[B, T_enc, D] stand in for the mel-spectrogram conv frontend.  Pre-LN
layernorm, GELU MLP with biases, learned encoder positions, cross-
attention in every decoder layer; the decoder's self-attention is the
shared GQA block (rope, ring-cache decode).

``use_kernels`` runs every attention the reference computes with
``attention_core`` through kernel K3: the encoder's bidirectional self-
attention (``causal=False``) and the decoder's causal one through the
flash autograd Function (``flash_vjp.flash_attention_vjp``, K3 in its
forward); the cross-attention (queries and keys of other lengths)
through K3's entry point (``kernels.flash_attention.ops``) in prefill and
decode.  ``whisper_loss`` trains the cross-attention through the plain
``attention_core`` (``cross_kernel=False``: the flash Function takes one
length for queries and keys).
Decode self-attention stays ``decode_attend``.  ``cfg.remat``
checkpoints each encoder and decoder layer, as the reference's
``jax.checkpoint(body)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer
from repro_torch.models.common import (ParamSpec, apply_norm, apply_rope,
                                       cast_tree, dot, norm_specs,
                                       stack_slice, stack_specs, torch_dtype)
from repro_torch.models.flash_vjp import flash_attention_vjp


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def cross_attention_specs(cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": ParamSpec((d, h * hd), ("embed", "heads")),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((h * hd, d), ("heads", "embed2")),
        "bq": ParamSpec((h * hd,), ("heads",), init="zeros"),
        "bv": ParamSpec((kv * hd,), ("kv_heads",), init="zeros"),
    }


def encoder_layer_specs(cfg):
    return {"ln1": norm_specs(cfg), "attn": attn.attention_specs(cfg),
            "ln2": norm_specs(cfg), "mlp": mlp_mod.mlp_specs(cfg)}


def decoder_layer_specs(cfg):
    return {"ln1": norm_specs(cfg), "attn": attn.attention_specs(cfg),
            "ln_x": norm_specs(cfg), "xattn": cross_attention_specs(cfg),
            "ln2": norm_specs(cfg), "mlp": mlp_mod.mlp_specs(cfg)}


def whisper_specs(cfg):
    e = cfg.encdec
    return {
        "embed": transformer.embed_specs(cfg),           # decoder token embed
        "enc_pos": ParamSpec((e.encoder_seq_len, cfg.d_model), (None, "embed"),
                             init="small"),
        "encoder": stack_specs(encoder_layer_specs(cfg), e.num_encoder_layers),
        "enc_norm": norm_specs(cfg),
        "decoder": stack_specs(decoder_layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_specs(cfg),
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def cross_attention_apply(cfg, p, x, enc_kv, *, use_kernels: bool = False):
    """x: [B,S,D]; enc_kv: precomputed {"k","v"}: [B,T,KV,hd]."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    cd = x.dtype
    q = (dot(x, p["wq"], cd) + p["bq"].to(cd)).reshape(B, S, H, hd)
    k, v = enc_kv["k"], enc_kv["v"]
    if use_kernels:
        out = flash_ops.flash_attention(q, k, v, causal=False,
                                        use_kernel=True)
    else:
        # cross-attention: no causal masking
        pos_q = torch.zeros((S,), dtype=torch.int32, device=x.device)
        pos_k = torch.zeros((k.shape[1],), dtype=torch.int32, device=x.device)
        out = attn.attention_core(q, k, v, pos_q, pos_k, causal=False)
    return dot(out.reshape(B, S, H * hd), p["wo"], cd)


def encode(cfg, params, frames, *, use_kernels: bool = False):
    """frames: [B,T,D] stub frame embeddings -> encoder output [B,T,D]."""
    cd = torch_dtype(cfg.compute_dtype)
    T = frames.shape[1]
    x = frames.to(cd) + params["enc_pos"][:T].to(cd)
    pos = torch.arange(T, dtype=torch.int32, device=x.device)
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def body(lp, x):
        h = apply_norm(cfg, lp["ln1"], x)
        # bidirectional self-attention
        B, S, _ = h.shape
        q = dot(h, lp["attn"]["wq"], cd)
        k = dot(h, lp["attn"]["wk"], cd)
        v = dot(h, lp["attn"]["wv"], cd)
        if cfg.qkv_bias:
            q = q + lp["attn"]["bq"].to(cd)
            k = k + lp["attn"]["bk"].to(cd)
            v = v + lp["attn"]["bv"].to(cd)
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, KV, hd)
        v = v.reshape(B, S, KV, hd)
        if use_kernels:
            a = flash_attention_vjp(q, k, v, causal=False,
                                    q_block=cfg.attn_q_block,
                                    kv_block=cfg.attn_kv_block,
                                    use_kernel=True)
        else:
            a = attn.attention_core(q, k, v, pos, pos, causal=False)
        x = x + dot(a.reshape(B, S, H * hd), lp["attn"]["wo"], cd)
        return x + mlp_mod.mlp_apply(cfg, lp["mlp"],
                                     apply_norm(cfg, lp["ln2"], x))

    fn = transformer._remat(cfg, body)
    for i in range(cfg.encdec.num_encoder_layers):
        x = fn(stack_slice(params["encoder"], i), x)
    return apply_norm(cfg, params["enc_norm"], x)


def _enc_kv(cfg, lp, enc_out):
    cd = enc_out.dtype
    B, T, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = dot(enc_out, lp["xattn"]["wk"], cd).reshape(B, T, KV, hd)
    v = (dot(enc_out, lp["xattn"]["wv"], cd)
         + lp["xattn"]["bv"].to(cd)).reshape(B, T, KV, hd)
    return {"k": k, "v": v}


def decoder_layer_apply(cfg, lp, x, positions, enc_out, cache=None, *,
                        use_kernels: bool = False, cross_kernel: bool = True):
    """Returns (x, cache_or_None); a decode step writes ``cache`` in
    place.  ``cross_kernel=False`` keeps the cross-attention plain under
    ``use_kernels`` (training)."""
    h = apply_norm(cfg, lp["ln1"], x)
    a, new_cache = attn.attention_apply(cfg, lp["attn"], h, positions,
                                        cache=cache, use_kernels=use_kernels)
    x = x + a
    h = apply_norm(cfg, lp["ln_x"], x)
    x = x + cross_attention_apply(cfg, lp["xattn"], h,
                                  _enc_kv(cfg, lp, enc_out),
                                  use_kernels=use_kernels and cross_kernel)
    x = x + mlp_mod.mlp_apply(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
    return x, new_cache


def whisper_loss(cfg, params, batch, *, use_kernels: bool = False):
    """batch: {"frames": [B,T,D], "tokens": [B,S], "labels": [B,S]}"""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    enc_out = encode(cfg, params, batch["frames"], use_kernels=use_kernels)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = transformer.embed_lookup(cfg, params, tokens, cd)
    fn = transformer._remat(cfg, lambda lp, x, enc_out: decoder_layer_apply(
        cfg, lp, x, positions, enc_out, use_kernels=use_kernels,
        cross_kernel=False)[0])
    for i in range(cfg.num_layers):
        x = fn(stack_slice(params["decoder"], i), x, enc_out)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = transformer.lm_head(cfg, params, x)
    return transformer.cross_entropy(logits, batch["labels"], cfg.vocab_size)


def whisper_prefill(cfg, params, frames, tokens, *, use_kernels: bool = False):
    """Encode + run the decoder over the prompt, building self-attention
    ring caches of exactly S slots (the reference's ``_fill_kv_cache(k, v,
    positions, S)``: the first decode step overwrites position 0).

    Returns (last_logits [B,V], {"self": stacked caches, "enc": enc_out})."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    enc_out = encode(cfg, params, frames, use_kernels=use_kernels)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = transformer.embed_lookup(cfg, params, tokens, cd)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    caches = []
    for i in range(cfg.num_layers):
        lp = stack_slice(params["decoder"], i)
        h = apply_norm(cfg, lp["ln1"], x)
        a, _ = attn.attention_apply(cfg, lp["attn"], h, positions,
                                    use_kernels=use_kernels)
        # K/V projected once more for the cache, as the reference does
        k = dot(h, lp["attn"]["wk"], cd)
        v = dot(h, lp["attn"]["wv"], cd)
        if cfg.qkv_bias:
            k = k + lp["attn"]["bk"].to(cd)
            v = v + lp["attn"]["bv"].to(cd)
        k = apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
        caches.append(transformer._fill_cache(
            {"k": k, "v": v.reshape(B, S, KV, hd)}, positions, S))
        x = x + a
        h = apply_norm(cfg, lp["ln_x"], x)
        x = x + cross_attention_apply(cfg, lp["xattn"], h,
                                      _enc_kv(cfg, lp, enc_out),
                                      use_kernels=use_kernels)
        x = x + mlp_mod.mlp_apply(cfg, lp["mlp"],
                                  apply_norm(cfg, lp["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = transformer.lm_head(cfg, params, x[:, -1:])
    stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    return logits[:, 0], {"self": stacked, "enc": enc_out}


def whisper_decode(cfg, params, tokens, state, *, use_kernels: bool = False):
    """One decode step; state = {"self": stacked [L, ...] ring caches
    (written in place), "enc": enc_out}.  The step's position is layer
    0's cache index, as in the reference."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    caches, enc_out = state["self"], state["enc"]
    positions = attn.decode_positions(caches["index"][0], tokens.shape[0])
    x = transformer.embed_lookup(cfg, params, tokens, cd)
    for i in range(cfg.num_layers):
        x, _ = decoder_layer_apply(
            cfg, stack_slice(params["decoder"], i), x, positions, enc_out,
            cache={k: v[i] for k, v in caches.items()},
            use_kernels=use_kernels)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = transformer.lm_head(cfg, params, x)
    return logits[:, 0], state
