"""Plain reference of the dense family (Qwen2-style): GQA with q/k/v bias,
rotary embedding, SwiGLU, RMS norms, untied head.  Float32, one layer's
weights widened at a time, each sequence a causal pass of its own.

Configuration keys (Hugging Face names): hidden_size, num_hidden_layers,
num_attention_heads, num_key_value_heads, intermediate_size, vocab_size,
rope_theta, rms_norm_eps; head_dim defaults to hidden / heads.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench.reference.common import (causal_attention, head_logits, layer,
                                    linear, matrix_std, rms_norm, rope,
                                    swiglu)


def dims(cfg: Dict) -> Dict[str, int]:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"D": D, "H": H, "KV": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or D // H,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"]}


def param_shapes(cfg: Dict):
    d = dims(cfg)
    D, L, q, kv = d["D"], d["L"], d["H"] * d["hd"], d["KV"] * d["hd"]
    return {
        "embed": (d["V"], D),
        "final_norm": {"scale": (D,)},
        "lm_head": (D, d["V"]),
        "layers": {
            "ln1": {"scale": (L, D)}, "ln2": {"scale": (L, D)},
            "attn": {"wq": (L, D, q), "wk": (L, D, kv), "wv": (L, D, kv),
                     "wo": (L, q, D), "bq": (L, q), "bk": (L, kv),
                     "bv": (L, kv)},
            "ff": {"w_gate": (L, D, d["F"]), "w_up": (L, D, d["F"]),
                   "w_down": (L, d["F"], D)},
        },
    }


def leaf_std(path: Sequence[str], shape) -> float:
    """How the benchmark draws each leaf: unit embeddings, norm offsets
    and biases of 0.2, matrices by fan-in."""
    name = path[-1]
    if name == "embed":
        return 1.0
    if name in ("scale", "bq", "bk", "bv"):
        return 0.2
    return matrix_std(shape)


def logits_at(cfg: Dict, weights, seqs: List[Sequence[int]],
              wanted: List[Sequence[int]], *, precision: str = "fp32"):
    """The logits [len(wanted[i]), V] (float32) at positions ``wanted[i]``
    of each token sequence ``seqs[i]``."""
    d = dims(cfg)
    H, KV, hd = d["H"], d["KV"], d["hd"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    dev = weights["embed"].device
    toks = [torch.as_tensor(list(s), dtype=torch.long, device=dev)
            for s in seqs]
    xs = [weights["embed"][t].float() for t in toks]
    for i in range(d["L"]):
        p = layer(weights["layers"], i)
        a = p["attn"]
        for j, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=dev)
            h = rms_norm(x, p["ln1"]["scale"], eps)
            q = (linear(h, a["wq"], precision) + a["bq"]).view(S, H, hd)
            k = (linear(h, a["wk"], precision) + a["bk"]).view(S, KV, hd)
            v = (linear(h, a["wv"], precision) + a["bv"]).view(S, KV, hd)
            q, k = rope(q, pos, theta), rope(k, pos, theta)
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
            o = causal_attention(q, k, v, hd ** -0.5).reshape(S, H * hd)
            x = x + linear(o, a["wo"], precision)
            h = rms_norm(x, p["ln2"]["scale"], eps)
            f = p["ff"]
            xs[j] = x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"],
                               precision)
        del p, a
    w = {"final_norm": {"scale": weights["final_norm"]["scale"].float()},
         "lm_head": weights["lm_head"]}
    return [head_logits(cfg, w, x[torch.as_tensor(list(pos), device=dev)],
                        "rms_norm_eps", precision)
            for x, pos in zip(xs, wanted)]
