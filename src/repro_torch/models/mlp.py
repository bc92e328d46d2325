"""Feed-forward substrate: SwiGLU / GEGLU / plain MLP.

Tensor parallelism: ``w_gate`` / ``w_up`` are column-parallel over the
hidden dim ("mlp"), ``w_down`` row-parallel; the partial sums meet in
``from_model`` before ``b_down`` is added once.
"""
from __future__ import annotations

from repro_torch.models.common import (ParamSpec, activation, dot,
                                       from_model, to_model)

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
    x = to_model(x, "mlp")
    if cfg.act in GATED:
        h = act(dot(x, p["w_gate"], cd)) * dot(x, p["w_up"], cd)
        return from_model(dot(h, p["w_down"], cd), "mlp")
    h = act(dot(x, p["w_up"], cd) + p["b_up"].to(cd))
    return from_model(dot(h, p["w_down"], cd), "mlp") + p["b_down"].to(cd)
