"""Feed-forward substrate: SwiGLU / GEGLU / plain MLP."""
from __future__ import annotations

from repro_torch.models.common import ParamSpec, activation, dot

GATED = ("swiglu", "geglu")


def mlp_specs(cfg, d_ff: int = 0):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act in GATED:
        return {
            "w_gate": ParamSpec((d, f), ("embed", "mlp")),
            "w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed2")),
        }
    return {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "b_up": ParamSpec((f,), ("mlp",), init="zeros"),
        "w_down": ParamSpec((f, d), ("mlp", "embed2")),
        "b_down": ParamSpec((d,), ("embed2",), init="zeros"),
    }


def mlp_apply(cfg, p, x):
    act = activation(cfg.act)
    cd = x.dtype
    if cfg.act in GATED:
        h = act(dot(x, p["w_gate"], cd)) * dot(x, p["w_up"], cd)
        return dot(h, p["w_down"], cd)
    h = act(dot(x, p["w_up"], cd) + p["b_up"].to(cd))
    return dot(h, p["w_down"], cd) + p["b_down"].to(cd)
