"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local attention.

Layer pattern (RG-2B): (recurrent, recurrent, attention) repeating over 26
layers = 8 super-blocks + 2 tail recurrent layers.

The RG-LRU recurrence (Griffin eq. 3-4):
    r_t = sigmoid(W_a x_t + b_a)                      (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                      (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of ``src/repro/models/rglru.py``, same names and pytree keys.
Prefill evaluates the recurrence with the reference's associative scan,
or — ``use_kernels``, the reference's ``use_pallas`` — through kernel K9
(``kernels/rglru_scan``; its plain sequential version on a CPU tensor).
The training forward always takes the scan, which autograd differentiates
(K9 has no backward); decode is the one-step recurrence.  The reference's
``lax.scan`` over the stacked ``blocks`` / ``tail`` leaves is a loop over
their slices.  Decode states are written in place (the slotted pool hands
in views of its slots); their ring caches may keep one position per row.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (ParamSpec, activation, apply_norm,
                                       cast_tree, dot, from_model,
                                       gather_model, local_extent,
                                       norm_specs, stack_len, stack_slice,
                                       stack_specs, stack_trees, to_model,
                                       torch_dtype, write_tree_)
from repro_torch.models.transformer import (_fill_cache, _remat,
                                            cross_entropy, embed_lookup,
                                            embed_specs, head_specs, lm_head)

C_EXP = 8.0


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _lru_width(cfg) -> int:
    """The RG-LRU width on this rank (its channels over the model axis)."""
    return local_extent(cfg.rglru.lru_width or cfg.d_model, "lru")


def recurrent_block_specs(cfg):
    d, w = cfg.d_model, cfg.rglru.lru_width or cfg.d_model
    cw = cfg.rglru.conv1d_width
    return {
        "ln": norm_specs(cfg),
        "w_x": ParamSpec((d, w), ("embed", "lru")),        # recurrence branch
        "w_gate": ParamSpec((d, w), ("embed", "lru")),     # gelu gate branch
        "conv_w": ParamSpec((cw, w), ("window", "lru"), init="small"),
        "conv_b": ParamSpec((w,), ("lru",), init="zeros"),
        "lru_lambda": ParamSpec((w,), ("lru",), init="normal"),
        "lru_wa": ParamSpec((w, w), ("lru_in", "lru")),
        "lru_ba": ParamSpec((w,), ("lru",), init="zeros"),
        "lru_wx": ParamSpec((w, w), ("lru_in", "lru")),
        "lru_bx": ParamSpec((w,), ("lru",), init="zeros"),
        "w_out": ParamSpec((w, d), ("lru", "embed2")),
        "ln2": norm_specs(cfg),
        "mlp": mlp_mod.mlp_specs(cfg),
    }


def attention_block_specs(cfg):
    return {"ln": norm_specs(cfg), "attn": attn.attention_specs(cfg),
            "ln2": norm_specs(cfg), "mlp": mlp_mod.mlp_specs(cfg)}


def super_block_specs(cfg):
    return {"rec1": recurrent_block_specs(cfg),
            "rec2": recurrent_block_specs(cfg),
            "attn": attention_block_specs(cfg)}


def rg_specs(cfg):
    n_super, n_tail = divmod(cfg.num_layers, 3)
    specs = {
        "embed": embed_specs(cfg),
        "blocks": stack_specs(super_block_specs(cfg), n_super),
        "final_norm": norm_specs(cfg),
    }
    if n_tail:
        specs["tail"] = stack_specs(recurrent_block_specs(cfg), n_tail)
    if not cfg.tie_embeddings:
        specs["lm_head"] = head_specs(cfg)
    return specs


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _lru_gates(p, x):
    """x: [B,S,W] -> (log_a, gated_input) both [B,S,W] fp32.  The gate
    matrices read the whole width: with the channels over the model axis
    their input is gathered (and their output is this rank's channels)."""
    x32 = x.float()
    xin = to_model(gather_model(x32, "lru"), "lru")
    r = torch.sigmoid(xin @ p["lru_wa"].float() + p["lru_ba"].float())
    i = torch.sigmoid(xin @ p["lru_wx"].float() + p["lru_bx"].float())
    lam = p["lru_lambda"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    log_a = -C_EXP * softplus * r
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * x32)
    return log_a, gated


def _combine(c1, c2):
    """The scan's operator: c1 then c2 over (log a, h) pairs."""
    (la1, g1), (la2, g2) = c1, c2
    return la1 + la2, g1 * torch.exp(la2) + g2


def associative_scan(la, g):
    """``jax.lax.associative_scan(_combine, (la, g), axis=1)`` by the same
    odd/even recursion, so the sums associate as the reference's do."""
    S = la.shape[1]
    if S < 2:
        return la, g
    rla, rg = _combine((la[:, 0:-1:2], g[:, 0:-1:2]), (la[:, 1::2], g[:, 1::2]))
    ola, og = associative_scan(rla, rg)
    if S % 2 == 0:
        ela, eg = _combine((ola[:, :-1], og[:, :-1]), (la[:, 2::2], g[:, 2::2]))
    else:
        ela, eg = _combine((ola, og), (la[:, 2::2], g[:, 2::2]))
    ela = torch.cat([la[:, :1], ela], dim=1)
    eg = torch.cat([g[:, :1], eg], dim=1)
    out_la = torch.empty_like(la)
    out_g = torch.empty_like(g)
    out_la[:, 0::2], out_la[:, 1::2] = ela, ola
    out_g[:, 0::2], out_g[:, 1::2] = eg, og
    return out_la, out_g


def rg_lru_scan(p, x, h0=None, use_kernels: bool = False):
    """Whole-sequence RG-LRU. x: [B,S,W]; h0: [B,W] or None.

    Returns (y [B,S,W] in x.dtype, h_last [B,W] fp32)."""
    log_a, gated = _lru_gates(p, x)
    if h0 is not None:
        # fold the incoming state in as a virtual step 0
        log_a = torch.cat([torch.zeros_like(log_a[:, :1]), log_a], dim=1)
        gated = torch.cat([h0[:, None, :].float(), gated], dim=1)
    if use_kernels:
        from repro_torch.kernels.rglru_scan import ops as lru_ops
        h = lru_ops.lru_scan(log_a, gated, use_kernel=True)
    else:
        _, h = associative_scan(log_a, gated)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1].float()


def rg_lru_step(p, x_t, h_prev):
    """One decode step. x_t: [B,W]; h_prev: [B,W] fp32."""
    log_a, gated = _lru_gates(p, x_t[:, None, :])
    h = torch.exp(log_a[:, 0]) * h_prev + gated[:, 0]
    return h.to(x_t.dtype), h


def causal_conv1d(p, x, state=None):
    """Depthwise causal conv, width cw. x: [B,S,W]; state: [B,cw-1,W] or None.

    Returns (y [B,S,W], new_state [B,cw-1,W])."""
    cw = p["conv_w"].shape[0]
    B, S, W = x.shape
    if state is None:
        state = torch.zeros((B, cw - 1, W), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)             # [B,S+cw-1,W]
    y = sum(xp[:, i:i + S] * p["conv_w"][i].to(x.dtype) for i in range(cw))
    y = y + p["conv_b"].to(x.dtype)
    return y, xp[:, -(cw - 1):]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

_gelu = activation("gelu")


def recurrent_block_apply(cfg, p, x, state=None, use_kernels=False):
    """state: {"conv": [B,cw-1,W], "h": [B,W] fp32} or None (train/prefill
    from zero state).  Returns (x, new_state)."""
    cd = x.dtype
    h_in = to_model(apply_norm(cfg, p["ln"], x), "lru")
    u = dot(h_in, p["w_x"], cd)
    gate = _gelu(dot(h_in, p["w_gate"], cd))
    conv_state = state["conv"] if state is not None else None
    u, new_conv = causal_conv1d(p, u, conv_state)
    if state is None:
        y, h_last = rg_lru_scan(p, u, use_kernels=use_kernels)
    else:
        y, h_last = rg_lru_step(p, u[:, 0], state["h"])
        y = y[:, None, :]
    new_state = {"conv": new_conv, "h": h_last}
    x = x + from_model(dot(y * gate, p["w_out"], cd), "lru")
    h2 = apply_norm(cfg, p["ln2"], x)
    x = x + mlp_mod.mlp_apply(cfg, p["mlp"], h2)
    return x, new_state


def attention_block_apply(cfg, p, x, positions, cache=None,
                          use_kernels=False):
    h = apply_norm(cfg, p["ln"], x)
    a, new_cache = attn.attention_apply(cfg, p["attn"], h, positions,
                                        cache=cache, use_kernels=use_kernels)
    x = x + a
    h2 = apply_norm(cfg, p["ln2"], x)
    x = x + mlp_mod.mlp_apply(cfg, p["mlp"], h2)
    return x, new_cache


def super_block_apply(cfg, p, x, positions, states=None, use_kernels=False):
    """One decode step (``states``) or the training forward (None).
    ``use_kernels`` is the attention's; the RG-LRU runs its one-step
    recurrence or the differentiable ``associative_scan`` (K9 has no
    backward, and runs only in ``rg_prefill``)."""
    s1 = states["rec1"] if states else None
    s2 = states["rec2"] if states else None
    sa = states["attn"] if states else None
    x, n1 = recurrent_block_apply(cfg, p["rec1"], x, s1)
    x, n2 = recurrent_block_apply(cfg, p["rec2"], x, s2)
    x, na = attention_block_apply(cfg, p["attn"], x, positions, sa,
                                  use_kernels)
    if states is None:
        return x, None
    return x, {"rec1": n1, "rec2": n2, "attn": na}


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

def rg_forward(cfg, params, tokens, use_kernels=False):
    """-> final-normed hidden [B,S,d], the training forward: attention
    through K3's autograd Function with ``use_kernels``, the RG-LRU always
    through ``associative_scan``, which is what the reference trains with
    (its loss runs with ``use_pallas`` False)."""
    cd = torch_dtype(cfg.compute_dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_lookup(cfg, params, tokens, cd)
    block_fn = _remat(cfg, lambda bp, x: super_block_apply(
        cfg, bp, x, positions, use_kernels=use_kernels)[0])
    for i in range(stack_len(params["blocks"])):
        x = block_fn(stack_slice(params["blocks"], i), x)
    if "tail" in params:
        tail_fn = _remat(cfg, lambda tp, x: recurrent_block_apply(
            cfg, tp, x)[0])
        for i in range(stack_len(params["tail"])):
            x = tail_fn(stack_slice(params["tail"], i), x)
    return apply_norm(cfg, params["final_norm"], x)


def rg_loss(cfg, params, batch, *, use_kernels=False):
    """batch: {"tokens", "labels"} [B,S] -> scalar fp32 loss, through
    ``rg_forward``."""
    params = cast_tree(params, cfg.compute_dtype)
    x = rg_forward(cfg, params, batch["tokens"], use_kernels=use_kernels)
    logits = lm_head(cfg, params, x)
    return cross_entropy(logits, batch["labels"], cfg.vocab_size)


# --- decode ----------------------------------------------------------------

def _rec_state_init(cfg, batch, device):
    w, cw = _lru_width(cfg), cfg.rglru.conv1d_width
    cd = torch_dtype(cfg.compute_dtype)
    return {"conv": torch.zeros((batch, cw - 1, w), dtype=cd, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def rg_init_states(cfg, batch: int, seq_len: int, device="cpu"):
    n_super, n_tail = divmod(cfg.num_layers, 3)
    cd = torch_dtype(cfg.compute_dtype)
    win = cfg.rglru.attention_window
    cache = attn.init_cache(batch, min(seq_len, win),
                            attn.local_heads(cfg)[1],
                            cfg.resolved_head_dim, cd, device)
    one = {"rec1": _rec_state_init(cfg, batch, device),
           "rec2": _rec_state_init(cfg, batch, device), "attn": cache}
    states = {"blocks": stack_trees([one] * n_super)}
    if n_tail:
        states["tail"] = stack_trees([_rec_state_init(cfg, batch, device)]
                                     * n_tail)
    return states


def rg_decode(cfg, params, tokens, states):
    """tokens [B,1] + states -> (logits [B,V], states), the states written
    in place.  The attention caches' position is shared by the batch or
    kept per row (the slotted pool's slots)."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    positions = attn.decode_positions(
        states["blocks"]["attn"]["index"][0], tokens.shape[0])
    x = embed_lookup(cfg, params, tokens, cd)
    for i in range(stack_len(params["blocks"])):
        st = stack_slice(states["blocks"], i)
        x, new = super_block_apply(cfg, stack_slice(params["blocks"], i), x,
                                   positions, st)
        write_tree_(st, new)
    if "tail" in params:
        for i in range(stack_len(params["tail"])):
            st = stack_slice(states["tail"], i)
            x, new = recurrent_block_apply(
                cfg, stack_slice(params["tail"], i), x, st)
            write_tree_(st, new)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params, x)
    return logits[:, 0], states


def rg_prefill(cfg, params, tokens, *, cache_len: int = 0,
               use_kernels=False):
    """Prefill: full forward while materializing final recurrent states and
    the local-attention ring caches.  Returns (last_logits [B,V], states).

    ``cache_len`` sets the ring-cache capacity (still bounded by the
    attention window); 0 keeps the prompt-length cache.  The serving engine
    passes its slot capacity so prefill states drop straight into a slot.
    ``use_kernels`` runs every RG-LRU scan through K9 and every local
    attention through K3 (the reference's ``use_pallas``)."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    win = cfg.rglru.attention_window
    KV = attn.local_heads(cfg)[1]
    x = embed_lookup(cfg, params, tokens, cd)

    def attn_prefill(p, x):
        h = apply_norm(cfg, p["ln"], x)
        a, _ = attn.attention_apply(cfg, p["attn"], h, positions,
                                    use_kernels=use_kernels)
        k = dot(h, p["attn"]["wk"], cd).reshape(B, S, KV, -1)
        v = dot(h, p["attn"]["wv"], cd).reshape(B, S, KV, -1)
        k = attn.apply_rope(k, positions, cfg.rope_theta)
        cache = _fill_cache({"k": k, "v": v}, positions,
                            min(cache_len or S, win))
        x = x + a
        x = x + mlp_mod.mlp_apply(cfg, p["mlp"],
                                  apply_norm(cfg, p["ln2"], x))
        return x, cache

    blocks = []
    for i in range(stack_len(params["blocks"])):
        bp = stack_slice(params["blocks"], i)
        x, s1 = recurrent_block_apply(cfg, bp["rec1"], x,
                                      use_kernels=use_kernels)
        x, s2 = recurrent_block_apply(cfg, bp["rec2"], x,
                                      use_kernels=use_kernels)
        x, ca = attn_prefill(bp["attn"], x)
        blocks.append({"rec1": s1, "rec2": s2, "attn": ca})
    states = {"blocks": stack_trees(blocks)}
    if "tail" in params:
        tail = []
        for i in range(stack_len(params["tail"])):
            x, st = recurrent_block_apply(cfg, stack_slice(params["tail"], i),
                                          x, use_kernels=use_kernels)
            tail.append(st)
        states["tail"] = stack_trees(tail)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params, x[:, -1:])
    return logits[:, 0], states
