"""RWKV-6 "Finch": attention-free time mixing with data-dependent decay.

Per layer:  time-mix (WKV6 recurrence over an outer-product state) +
channel-mix (squared-relu MLP with token-shift lerp).

WKV6 per head (state S in R^{hd x hd}, decay w_t data-dependent — the Finch
hallmark, arXiv:2404.05892):
    out_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

The port of ``src/repro/models/rwkv6.py``, same names and pytree keys.
Without kernels the recurrence is the reference's sequential loop over
time; ``use_kernels`` (the reference's ``use_pallas``) runs it through
kernel K10 (``kernels/rwkv6_wkv``; its plain version on a CPU tensor);
the training loss always takes the loop, which autograd differentiates
(K10 has no backward); decode is the one-step form.  The reference's ``lax.scan`` over the
stacked ``layers`` leaves is a loop over their slices; decode states are
written in place (the slotted pool hands in views of its slots).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ParamSpec, apply_norm, cast_tree, dot,
                                       from_model, local_chunk, local_extent,
                                       norm_specs, stack_len, stack_slice,
                                       stack_specs, stack_trees, to_model,
                                       torch_dtype, write_tree_)
from repro_torch.models.transformer import (_remat, cross_entropy,
                                            embed_lookup, embed_specs,
                                            head_specs, lm_head)


def _heads(cfg):
    """(heads on this rank, head size): the WKV heads over the model
    axis."""
    hd = cfg.rwkv.head_size
    return local_extent(cfg.d_model // hd, "heads"), hd


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def time_mix_specs(cfg):
    d = cfg.d_model
    hd = cfg.rwkv.head_size
    h = d // hd
    r = cfg.rwkv.decay_lora
    return {
        "ln": norm_specs(cfg),
        "mu_r": ParamSpec((d,), ("embed",), init="small"),
        "mu_k": ParamSpec((d,), ("embed",), init="small"),
        "mu_v": ParamSpec((d,), ("embed",), init="small"),
        "mu_g": ParamSpec((d,), ("embed",), init="small"),
        "mu_w": ParamSpec((d,), ("embed",), init="small"),
        "w_r": ParamSpec((d, d), ("embed", "heads")),
        "w_k": ParamSpec((d, d), ("embed", "heads")),
        "w_v": ParamSpec((d, d), ("embed", "heads")),
        "w_g": ParamSpec((d, d), ("embed", "heads")),
        "w_o": ParamSpec((d, d), ("heads", "embed2")),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "decay_w0": ParamSpec((d,), ("embed",), init="small"),
        "decay_a": ParamSpec((d, r), ("embed", "rank"), init="small"),
        "decay_b": ParamSpec((r, d), ("rank", "embed2"), init="small"),
        "bonus_u": ParamSpec((h, hd), (None, None), init="small"),
        # per-head output groupnorm
        "gn_scale": ParamSpec((d,), ("embed",), init="ones"),
        "gn_bias": ParamSpec((d,), ("embed",), init="zeros"),
    }


def channel_mix_specs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": norm_specs(cfg),
        "mu_k": ParamSpec((d,), ("embed",), init="small"),
        "mu_r": ParamSpec((d,), ("embed",), init="small"),
        "w_k": ParamSpec((d, f), ("embed", "mlp")),
        "w_v": ParamSpec((f, d), ("mlp", "embed2")),
        "w_r": ParamSpec((d, d), ("embed", "embed2")),
    }


def layer_specs(cfg):
    return {"tm": time_mix_specs(cfg), "cm": channel_mix_specs(cfg)}


def rwkv_specs(cfg):
    specs = {
        "embed": embed_specs(cfg),
        "layers": stack_specs(layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = head_specs(cfg)
    return specs


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------

def wkv_scan(r, k, v, w, u, s0=None, use_kernels: bool = False):
    """r,k,v,w: [B,S,H,hd] (w = decay in (0,1), fp32); u: [H,hd].

    Returns (out [B,S,H,hd] fp32, s_last [B,H,hd,hd] fp32)."""
    B, S, H, hd = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    if use_kernels:
        from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
        return wkv_ops.wkv6(r, k, v, w, u, s0, use_kernel=True)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    s = s0
    outs = []
    for t in range(S):
        out, s = wkv_step(rf[:, t], kf[:, t], vf[:, t], wf[:, t], u, s)
        outs.append(out)
    return torch.stack(outs, dim=1), s


def wkv_step(r, k, v, w, u, s):
    """One step; r,k,v,w: [B,H,hd]."""
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhi,bhij->bhj", r, s + u[None, :, :, None] * kv)
    s = w[..., :, None] * s + kv
    return out, s


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _lerp(x, z, mu):
    return x + (z - x) * mu.to(x.dtype)


def _shift(x, last=None):
    """z_t = x_{t-1}; last: [B,D] carries state across decode steps."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _decay(p, xw):
    """Data-dependent per-channel decay in (0,1), fp32."""
    x32 = xw.float()
    lora = torch.tanh(x32 @ p["decay_a"].float()) @ p["decay_b"].float()
    return torch.exp(-torch.exp(p["decay_w0"].float() + lora))


def time_mix_apply(cfg, p, x, state=None, use_kernels=False):
    """state: {"x": [B,D], "s": [B,H,hd,hd]} or None. -> (y, new_state).

    Tensor parallelism: r/k/v/g are column-parallel over the WKV heads,
    ``w_o`` row-parallel; the per-channel decay, the bonus and the group
    norm's affine are whole on every rank and read at this rank's heads
    (``local_chunk``), so the recurrence (K10) runs on the local heads."""
    cd = x.dtype
    B, S, D = x.shape
    H, hd = _heads(cfg)
    xin = apply_norm(cfg, p["ln"], x)
    z = _shift(xin, state["x"] if state is not None else None)

    def col(mu, w):                     # a column-parallel projection
        return dot(to_model(_lerp(xin, z, p[mu]), "heads"), p[w], cd)

    r = col("mu_r", "w_r").reshape(B, S, H, hd)
    k = col("mu_k", "w_k").reshape(B, S, H, hd)
    v = col("mu_v", "w_v").reshape(B, S, H, hd)
    g = F.silu(col("mu_g", "w_g"))
    w = local_chunk(to_model(_decay(p, _lerp(xin, z, p["mu_w"])), "heads"),
                    "heads").reshape(B, S, H, hd)
    u = local_chunk(to_model(p["bonus_u"].float(), "heads"), "heads", 0)

    if state is None:
        out, s_last = wkv_scan(r, k, v, w, u, use_kernels=use_kernels)
    else:
        out, s_last = wkv_step(r[:, 0].float(), k[:, 0].float(),
                               v[:, 0].float(), w[:, 0], u, state["s"])
        out = out[:, None]
    new_state = {"x": xin[:, -1], "s": s_last}

    # per-head group norm on the flattened head outputs
    out = out.reshape(B, S, H, hd)
    mu = torch.mean(out, dim=-1, keepdim=True)
    var = torch.var(out, dim=-1, keepdim=True, unbiased=False)
    out = (out - mu) * torch.rsqrt(var + 64e-5)
    out = out.reshape(B, S, H * hd).to(cd)
    gn = {n: local_chunk(to_model(p[n], "heads"), "heads")
          for n in ("gn_scale", "gn_bias")}
    out = out * gn["gn_scale"].to(cd) + gn["gn_bias"].to(cd)
    y = from_model(dot(out * g, p["w_o"], cd), "heads")
    return x + y, new_state


def channel_mix_apply(cfg, p, x, state=None):
    cd = x.dtype
    xin = apply_norm(cfg, p["ln"], x)
    z = _shift(xin, state)
    k = dot(to_model(_lerp(xin, z, p["mu_k"]), "mlp"), p["w_k"], cd)
    k = torch.square(F.relu(k))
    kv = from_model(dot(k, p["w_v"], cd), "mlp")
    rr = torch.sigmoid(dot(_lerp(xin, z, p["mu_r"]), p["w_r"], cd))
    return x + rr * kv, xin[:, -1]


def layer_apply(cfg, p, x, state=None, use_kernels=False):
    """One layer; with ``state`` (decode) it is written in place.  Returns
    (x, new_state) — new_state None without one, as the reference's."""
    tm_state = state["tm"] if state is not None else None
    cm_state = state["cm"] if state is not None else None
    x, new_tm = time_mix_apply(cfg, p["tm"], x, tm_state, use_kernels)
    x, new_cm = channel_mix_apply(cfg, p["cm"], x, cm_state)
    if state is None:
        return x, None
    new = {"tm": new_tm, "cm": new_cm}
    write_tree_(state, new)
    return x, state


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def rwkv_forward(cfg, params, tokens, use_kernels=False):
    """-> final-normed hidden [B,S,d]; ``use_kernels`` runs every WKV
    recurrence through K10, which has no backward (see ``rwkv_loss``)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(cfg, params, tokens, cd)
    fn = _remat(cfg, lambda lp, x: layer_apply(cfg, lp, x,
                                               use_kernels=use_kernels)[0])
    for i in range(cfg.num_layers):
        x = fn(stack_slice(params["layers"], i), x)
    return apply_norm(cfg, params["final_norm"], x)


def rwkv_loss(cfg, params, batch, *, use_kernels=False):
    """batch: {"tokens", "labels"} [B,S] -> scalar fp32 loss.  The WKV
    recurrence runs as ``wkv_scan``'s sequential loop, which autograd
    differentiates: what the reference trains with (its loss runs with
    ``use_pallas`` False); K10, like its Pallas kernel, has no backward.
    The family has no attention, so ``use_kernels`` (the train contract's
    K3 switch) changes nothing."""
    params = cast_tree(params, cfg.compute_dtype)
    x = rwkv_forward(cfg, params, batch["tokens"])
    logits = lm_head(cfg, params, x)
    return cross_entropy(logits, batch["labels"], cfg.vocab_size)


def rwkv_init_states(cfg, batch: int, device="cpu"):
    H, hd = _heads(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    one = {
        "tm": {"x": torch.zeros((batch, cfg.d_model), dtype=cd,
                                device=device),
               "s": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                device=device)},
        "cm": torch.zeros((batch, cfg.d_model), dtype=cd, device=device),
    }
    return stack_trees([one] * cfg.num_layers)


def rwkv_decode(cfg, params, tokens, states):
    """tokens [B,1] -> (logits [B,V], states), the states written in
    place.  Position-free (no rope)."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(cfg, params, tokens, cd)
    for i in range(stack_len(params["layers"])):
        x, _ = layer_apply(cfg, stack_slice(params["layers"], i), x,
                           stack_slice(states, i))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params, x)
    return logits[:, 0], states


def rwkv_prefill(cfg, params, tokens, *, use_kernels=False):
    """Full forward materializing final states. -> (last_logits, states).
    ``use_kernels`` runs every WKV recurrence through K10."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(cfg, params, tokens, cd)
    states = []
    for i in range(stack_len(params["layers"])):
        lp = stack_slice(params["layers"], i)
        x, tm_state = time_mix_apply(cfg, lp["tm"], x,
                                     use_kernels=use_kernels)
        x, cm_state = channel_mix_apply(cfg, lp["cm"], x)
        states.append({"tm": tm_state, "cm": cm_state})
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params, x[:, -1:])
    return logits[:, 0], stack_trees(states)
