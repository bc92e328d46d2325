"""Plain reference of K-EXAONE (``exaone_moe``): the EXAONE 4 block with
DeepSeek-V3's router, as one card of an expert-parallel deployment holds
it.  Float32, one layer's weights widened at a time, each sequence a pass
of its own.

The block (transformers' ``exaone4`` modeling): no norm before a sublayer;
``h = x + post_attention_norm(attn(x))``, then ``out = h +
post_feedforward_norm(mlp(h))``.  Attention is GQA with a per-head RMS norm
of q and k, then rope on the sliding layers only (the full layers use no
positional encoding); a sliding query attends its ``sliding_window``
latest keys, itself included; a full one every key up to its own.

The MLP of a ``dense`` layer is a SwiGLU of ``intermediate_size``; of a
``sparse`` layer, the routed experts plus ``num_shared_experts`` shared
SwiGLUs of ``moe_intermediate_size``.  The router (DeepSeek-V3's
``TopkRouter`` at one group) scores the ``router_experts`` experts by
sigmoid(h W_router), chooses the top ``num_experts_per_tok`` of the scores
plus ``e_score_correction_bias``, and weights each pick by its score
without the bias, normalised over the picks (``+ 1e-20``) and multiplied by
``routed_scaling_factor``.  Only the experts this card holds, the first
``num_experts`` of them, add their part; the others' picks add nothing
here (they lie on the deployment's other cards).  Norm scales are stored
as offsets from one.

Configuration keys (Hugging Face names): hidden_size, num_hidden_layers,
num_attention_heads, num_key_value_heads, head_dim, intermediate_size,
moe_intermediate_size, num_experts (held here), router_experts,
num_experts_per_tok, num_shared_experts, routed_scaling_factor,
layer_types, mlp_layer_types, sliding_window, rope_parameters.rope_theta,
rms_norm_eps, vocab_size.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench.reference.common import (causal_attention, head_logits, layer,
                                    linear, matrix_std, no_tf32, rms_norm,
                                    rope, swiglu)


def dims(cfg: Dict) -> Dict:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    kinds = cfg["mlp_layer_types"]
    return {"D": D, "H": H, "KV": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or D // H,
            "F": cfg["intermediate_size"], "f": cfg["moe_intermediate_size"],
            "fs": cfg["moe_intermediate_size"] * cfg["num_shared_experts"],
            "E": cfg["router_experts"], "held": cfg["num_experts"],
            "K": cfg["num_experts_per_tok"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"],
            "n_dense": sum(k == "dense" for k in kinds),
            "window": cfg["sliding_window"]}


def _attn_shapes(n: int, d: Dict):
    D, q, kv = d["D"], d["H"] * d["hd"], d["KV"] * d["hd"]
    return {"wq": (n, D, q), "wk": (n, D, kv), "wv": (n, D, kv),
            "wo": (n, q, D), "q_norm": (n, d["hd"]), "k_norm": (n, d["hd"])}


def param_shapes(cfg: Dict):
    """The program's tree: the leading dense layers' stack and the sparse
    layers' stack."""
    d = dims(cfg)
    D, nd = d["D"], d["n_dense"]
    ns = d["L"] - nd
    norms = lambda n: {"ln1": {"scale": (n, D)}, "ln2": {"scale": (n, D)}}
    return {
        "embed": (d["V"], D),
        "final_norm": {"scale": (D,)},
        "lm_head": (D, d["V"]),
        "dense_layers": {
            **norms(nd), "attn": _attn_shapes(nd, d),
            "ff": {"w_gate": (nd, D, d["F"]), "w_up": (nd, D, d["F"]),
                   "w_down": (nd, d["F"], D)}},
        "layers": {
            **norms(ns), "attn": _attn_shapes(ns, d),
            "ff": {"router": (ns, D, d["E"]),
                   "e_score_correction_bias": (ns, d["E"]),
                   "w_gate": (ns, d["held"], D, d["f"]),
                   "w_up": (ns, d["held"], D, d["f"]),
                   "w_down": (ns, d["held"], d["f"], D),
                   "shared": {"w_gate": (ns, D, d["fs"]),
                              "w_up": (ns, D, d["fs"]),
                              "w_down": (ns, d["fs"], D)}}},
    }


def leaf_std(path: Sequence[str], shape) -> float:
    """Unit embeddings, norm offsets of 0.2, a correction bias of 0.1 (on
    sigmoid scores in (0, 1), enough to move the choice off the gates'
    order), matrices by fan-in."""
    name = path[-1]
    if name == "embed":
        return 1.0
    if name in ("scale", "q_norm", "k_norm"):
        return 0.2
    if name == "e_score_correction_bias":
        return 0.1
    return matrix_std(shape)


def windowed_attention(q, k, v, scale: float, window: int,
                       block: int = 512):
    """q, k, v [S, H, d] (heads matched) -> [S, H, d]: query ``i`` attends
    keys ``j`` with ``i - window < j <= i``; each query block reads only
    the keys its window reaches."""
    S = q.shape[0]
    out = []
    for q0 in range(0, S, block):
        n = min(block, S - q0)
        k0 = max(0, q0 - window + 1)
        qb = q[q0:q0 + n].permute(1, 0, 2)                   # [H, n, d]
        kb = k[k0:q0 + n].permute(1, 2, 0)                   # [H, d, T]
        s = torch.matmul(qb, kb) * scale                     # [H, n, T]
        qi = torch.arange(q0, q0 + n, device=q.device)[:, None]
        ki = torch.arange(k0, q0 + n, device=q.device)[None, :]
        s = s.masked_fill((ki > qi) | (ki <= qi - window), float("-inf"))
        out.append(torch.matmul(torch.softmax(s, dim=-1),
                                v[k0:q0 + n].permute(1, 0, 2))
                   .permute(1, 0, 2))
    return torch.cat(out, dim=0)


def attention(d, a, x, pos, sliding: bool, eps: float, theta: float,
              precision: str):
    """One layer's attention of x [S, D] (no norm before it)."""
    S = x.shape[0]
    H, KV, hd = d["H"], d["KV"], d["hd"]
    q = linear(x, a["wq"], precision).view(S, H, hd)
    k = linear(x, a["wk"], precision).view(S, KV, hd)
    v = linear(x, a["wv"], precision).view(S, KV, hd)
    q, k = rms_norm(q, a["q_norm"], eps), rms_norm(k, a["k_norm"], eps)
    if sliding:                       # the full layers take no rope
        q, k = rope(q, pos, theta), rope(k, pos, theta)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    o = (windowed_attention(q, k, v, hd ** -0.5, d["window"]) if sliding
         else causal_attention(q, k, v, hd ** -0.5))
    return linear(o.reshape(S, H * hd), a["wo"], precision)


def route(cfg: Dict, d: Dict, f, h, precision: str):
    """(gates [S, K], picks [S, K]): choice on sigmoid scores plus the
    correction bias, gates the scores without it, normalised and
    scaled."""
    scores = torch.sigmoid(linear(h, f["router"], precision))
    choice = scores + f["e_score_correction_bias"]
    sel = torch.sort(choice, dim=-1, descending=True,
                     stable=True)[1][:, :d["K"]]
    gates = scores.gather(1, sel)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * cfg["routed_scaling_factor"], sel


def moe(cfg: Dict, d: Dict, f, h, precision: str):
    """The held experts' part of the routed sum, plus the shared experts:
    h [S, D] -> [S, D]."""
    gates, sel = route(cfg, d, f, h, precision)
    out = torch.zeros_like(h)
    for e in range(d["held"]):
        tok, slot = torch.nonzero(sel == e, as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], f["w_gate"][e], f["w_up"][e],
                       f["w_down"][e], precision)
            out.index_add_(0, tok, y * gates[tok, slot, None])
    s = f["shared"]
    return out + swiglu(h, s["w_gate"], s["w_up"], s["w_down"], precision)


def logits_at(cfg: Dict, weights, seqs: List[Sequence[int]],
              wanted: List[Sequence[int]], *, precision: str = "fp32"):
    """The logits [len(wanted[i]), V] (float32) at positions ``wanted[i]``
    of each token sequence ``seqs[i]``."""
    no_tf32()
    d = dims(cfg)
    eps = cfg["rms_norm_eps"]
    theta = cfg["rope_parameters"]["rope_theta"]
    dev = weights["embed"].device
    toks = [torch.as_tensor(list(s), dtype=torch.long, device=dev)
            for s in seqs]
    xs = [weights["embed"][t].float() for t in toks]
    for i in range(d["L"]):
        dense = cfg["mlp_layer_types"][i] == "dense"
        sliding = cfg["layer_types"][i] == "sliding_attention"
        p = (layer(weights["dense_layers"], i) if dense
             else layer(weights["layers"], i - d["n_dense"]))
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[0], device=dev)
            a = attention(d, p["attn"], x, pos, sliding, eps, theta,
                          precision)
            x = x + rms_norm(a, p["ln1"]["scale"], eps)
            f = p["ff"]
            y = (swiglu(x, f["w_gate"], f["w_up"], f["w_down"], precision)
                 if dense else moe(cfg, d, f, x, precision))
            xs[j] = x + rms_norm(y, p["ln2"]["scale"], eps)
        del p
    w = {"final_norm": {"scale": weights["final_norm"]["scale"].float()},
         "lm_head": weights["lm_head"]}
    return [head_logits(cfg, w, x[torch.as_tensor(list(pos), device=dev)],
                        "rms_norm_eps", precision)
            for x, pos in zip(xs, wanted)]
