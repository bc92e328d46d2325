"""Optimizer substrate (the source paper names AdaGrad, Adam, Momentum SGD).

The port of ``src/repro/optim/optimizers.py``, functional over nested dicts
of tensors:

    opt = make_optimizer(OptimizerConfig(name="adam", lr=1e-3))
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

All state is fp32 over fp32 master weights; the loss casts the masters to
the compute dtype (mixed precision) and ``update`` consumes fp32 gradients.
The ZeRO-1 ``reduce_scatter`` strategy runs the same optimizers over a
one-leaf tree ``{"flat": [1, shard]}`` — a rank's slice of the flat fp32
parameter vector — so the flat-shard variants are these functions on that
tree, with the same math.

**In place.**  Unlike the JAX package's pure functions, ``update`` writes
the new values into ``params`` and the state tensors where they lie and
returns the same objects: at full width a second copy of the masters or
of the Adam moments would not fit beside the first.  ``clip_by_global_norm``
likewise scales the gradients in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.common import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]   # (grads, state, params)
    cfg: OptimizerConfig


def _zeros(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _pairs(*trees):
    """Zip the leaves of trees of one structure (sorted-key order)."""
    return zip(*(tree_leaves(t) for t in trees))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float, *, norm=None):
    """Scale ``grads`` (fp32, in place) so their global norm is at most
    ``max_norm``; returns (grads, norm before clipping).  ``norm`` is
    that norm when the caller has it (gradients sharded over a mesh)."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, gn


def _next_step(state) -> torch.Tensor:
    return state["step"] + 1


# ---------------------------------------------------------------------------
# SGD / momentum
# ---------------------------------------------------------------------------

def _sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params):
        for p, g in _pairs(params, grads):
            p.sub_(cfg.lr * g.to(p.dtype))
        return params, {"step": _next_step(state)}

    return Optimizer(init, update, cfg)


def _momentum(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32), "v": _zeros(params)}

    def update(grads, state, params):
        for p, g, v in _pairs(params, grads, state["v"]):
            v.mul_(cfg.momentum).add_(g.float())
            p.sub_(cfg.lr * v.to(p.dtype))
        return params, {"step": _next_step(state), "v": state["v"]}

    return Optimizer(init, update, cfg)


# ---------------------------------------------------------------------------
# AdaGrad
# ---------------------------------------------------------------------------

def _adagrad(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "acc": _zeros(params)}

    def update(grads, state, params):
        for p, g, a in _pairs(params, grads, state["acc"]):
            g32 = g.float()
            a.add_(torch.square(g32))
            p.sub_((cfg.lr * g32 / (torch.sqrt(a) + cfg.eps)).to(p.dtype))
        return params, {"step": _next_step(state), "acc": state["acc"]}

    return Optimizer(init, update, cfg)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

def _adam(cfg: OptimizerConfig, decoupled_wd: bool) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params):
        t = _next_step(state)
        b1, b2 = cfg.beta1, cfg.beta2
        # bias corrections in fp32, as the JAX package computes them
        tf = np.float32(int(t))
        bc1 = float(np.float32(1) - np.float32(b1) ** tf)
        bc2 = float(np.float32(1) - np.float32(b2) ** tf)
        for p, g, m, v in _pairs(params, grads, state["m"], state["v"]):
            g32 = g.float()
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            denom = (v / bc2).sqrt_().add_(cfg.eps)
            if decoupled_wd and cfg.weight_decay:
                p.mul_(1 - cfg.lr * cfg.weight_decay)
            p.addcdiv_(m, denom, value=-cfg.lr / bc1)
        return params, {"step": t, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update, cfg)


_FACTORY = {
    "sgd": lambda c: _sgd(c),
    "momentum": lambda c: _momentum(c),
    "adagrad": lambda c: _adagrad(c),
    "adam": lambda c: _adam(c, False),
    "adamw": lambda c: _adam(c, True),
}


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    try:
        fac = _FACTORY[cfg.name]
    except KeyError:
        raise KeyError(f"unknown optimizer {cfg.name!r}: {sorted(_FACTORY)}") from None
    return fac(cfg)


