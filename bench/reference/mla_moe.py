"""Plain reference of the MLA + MoE family (DeepSeek-V2-style): latent
attention (compressed kv with its own RMS norm, a shared rotary key, no q
compression), every layer a mixture of experts (softmax router, top-k,
gates renormalised to sum one, SwiGLU experts) plus shared experts.
Float32, one layer's weights widened at a time.

Configuration keys (Hugging Face names): hidden_size, num_hidden_layers,
num_attention_heads, kv_lora_rank, qk_nope_head_dim, qk_rope_head_dim,
v_head_dim, n_routed_experts, num_experts_per_tok, moe_intermediate_size,
n_shared_experts, vocab_size, rope_theta, rms_norm_eps, rope_scaling.  The
softmax scale is (nope + rope) ** -0.5 and the rotary angles are unscaled:
``rope_scaling`` is null or yarn at a factor of at most 1, which is the
same (its interpolated and extrapolated frequencies coincide and its
mscale is 1); any other scaling is refused.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench.reference.common import (causal_attention, head_logits, layer,
                                    linear, matrix_std, rms_norm, rope,
                                    swiglu)


def dims(cfg: Dict) -> Dict[str, int]:
    return {"D": cfg["hidden_size"], "H": cfg["num_attention_heads"],
            "R": cfg["kv_lora_rank"], "nope": cfg["qk_nope_head_dim"],
            "rp": cfg["qk_rope_head_dim"], "dv": cfg["v_head_dim"],
            "E": cfg["n_routed_experts"], "K": cfg["num_experts_per_tok"],
            "f": cfg["moe_intermediate_size"],
            "fs": cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
            "V": cfg["vocab_size"], "L": cfg["num_hidden_layers"]}


def plain_rope(cfg: Dict) -> None:
    """Refuse a ``rope_scaling`` that changes the rotary angles or the
    softmax scale: this reference computes unscaled rope only."""
    rs = cfg.get("rope_scaling")
    if rs is None or (rs.get("type", rs.get("rope_type")) == "yarn"
                      and rs.get("factor", 1) <= 1):
        return
    raise ValueError(f"rope_scaling {rs!r} is not unscaled rope")


def param_shapes(cfg: Dict):
    d = dims(cfg)
    D, L, H, E, f = d["D"], d["L"], d["H"], d["E"], d["f"]
    return {
        "embed": (d["V"], D),
        "final_norm": {"scale": (D,)},
        "lm_head": (D, d["V"]),
        "layers": {
            "ln1": {"scale": (L, D)}, "ln2": {"scale": (L, D)},
            "attn": {"w_dkv": (L, D, d["R"] + d["rp"]),
                     "kv_norm": (L, d["R"]),
                     "w_uk": (L, d["R"], H * d["nope"]),
                     "w_uv": (L, d["R"], H * d["dv"]),
                     "wo": (L, H * d["dv"], D),
                     "wq": (L, D, H * (d["nope"] + d["rp"]))},
            "ff": {"router": (L, D, E), "w_gate": (L, E, D, f),
                   "w_up": (L, E, D, f), "w_down": (L, E, f, D),
                   "shared": {"w_gate": (L, D, d["fs"]),
                              "w_up": (L, D, d["fs"]),
                              "w_down": (L, d["fs"], D)}},
        },
    }


def leaf_std(path: Sequence[str], shape) -> float:
    name = path[-1]
    if name == "embed":
        return 1.0
    if name in ("scale", "kv_norm"):
        return 0.2
    return matrix_std(shape)


def _moe(cfg, d, f, h, precision):
    """Routed experts (top-k of a softmax, gates renormalised) plus the
    shared experts: h [S, D] -> [S, D]."""
    probs = torch.softmax(linear(h, f["router"], precision), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, sel = vals[:, :d["K"]], idx[:, :d["K"]]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(h)
    for e in range(d["E"]):
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
    plain_rope(cfg)
    d = dims(cfg)
    H, R, nope, rp, dv = d["H"], d["R"], d["nope"], d["rp"], d["dv"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    scale = (nope + rp) ** -0.5
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
            dkv = linear(h, a["w_dkv"], precision)
            ckv = rms_norm(dkv[:, :R], a["kv_norm"], eps)
            krope = rope(dkv[:, None, R:], pos, theta)      # [S, 1, rp]
            q = linear(h, a["wq"], precision).view(S, H, nope + rp)
            q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)],
                          dim=-1)
            k_nope = linear(ckv, a["w_uk"], precision).view(S, H, nope)
            v = linear(ckv, a["w_uv"], precision).view(S, H, dv)
            k = torch.cat([k_nope, krope.expand(S, H, rp)], dim=-1)
            o = causal_attention(q, k, v, scale).reshape(S, H * dv)
            x = x + linear(o, a["wo"], precision)
            h = rms_norm(x, p["ln2"]["scale"], eps)
            xs[j] = x + _moe(cfg, d, p["ff"], h, precision)
        del p, a
    w = {"final_norm": {"scale": weights["final_norm"]["scale"].float()},
         "lm_head": weights["lm_head"]}
    return [head_logits(cfg, w, x[torch.as_tensor(list(pos), device=dev)],
                        "rms_norm_eps", precision)
            for x, pos in zip(xs, wanted)]
