"""Parameter-spec system + shared layer primitives (PyTorch).

Every model in ``repro_torch.models`` is functional, as in the JAX package:

  ``param_specs(cfg) -> tree[ParamSpec]``   (nested dicts of specs)
  ``apply(cfg, params, inputs, ...) -> outputs``

Parameters are nested dicts of tensors keyed exactly like the JAX
package's pytree (stacked ``[L, ...]`` layer leaves included), so weights
carry across key for key (``repro_torch.convert.from_jax_params``).  The
sharding rules (logical axis -> mesh axis) are not ported yet; ``axes`` is
kept on every spec so they can be.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# ParamSpec
# ---------------------------------------------------------------------------

INITS = ("normal", "scaled", "zeros", "ones", "embed", "small")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (torch dtypes pass through)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}"
                         ) from None


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names, len == len(shape)
    init: str = "scaled"                     # fan-in scaled normal
    dtype: str = "float32"
    fan_in_axis: int = -2                    # which axis is fan-in for "scaled"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)
        assert self.init in INITS, self.init


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict (specs or tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a nested dict in the JAX pytree order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def tree_unflatten(leaves, like):
    """Inverse of ``tree_leaves``: a tree shaped like ``like`` holding
    ``leaves`` (in sorted-key order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def stack_slice(tree, i: int):
    """Slice ``i`` of a tree of stacked ``[n, ...]`` leaves (views)."""
    return tree_map(lambda t: t[i], tree)


def stack_trees(trees):
    """Stack a list of equally shaped trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def stack_len(tree) -> int:
    """Leading (stacked-layer) length of a tree of ``[n, ...]`` leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def write_tree_(dst, src):
    """Copy ``src``'s leaves into ``dst``'s, in place (leaves that already
    are the same tensor — a ring cache written in place — are skipped)."""
    if isinstance(dst, dict):
        for k in dst:
            write_tree_(dst[k], src[k])
    elif dst is not src:
        dst.copy_(src)


def stack_specs(tree, n: int):
    """Prepend a stacked-layer dimension (logical axis "layers")."""
    def one(s: ParamSpec):
        fan = s.fan_in_axis
        # keep fan-in pointing at the same physical axis after stacking
        if fan >= 0:
            fan += 1
        return ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.dtype, fan)
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

def _init_one(spec: ParamSpec, gen: torch.Generator, device, dtype):
    """One leaf: drawn in fp32 on ``device`` and cast to ``dtype`` at once
    (the fp32 draw is freed before the next leaf is made)."""
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if spec.init in ("embed", "small"):
        x.mul_(0.02 if spec.init == "embed" else 1e-2)
    elif spec.init == "scaled":
        fan_axis = spec.fan_in_axis if len(shape) > 1 else 0
        x.mul_(1.0 / math.sqrt(max(shape[fan_axis], 1)))
    return x.to(dtype)


def init_params(spec_tree, gen: torch.Generator, *, device="cpu",
                dtype=None):
    """Materialize a ParamSpec tree (leaves in sorted-key order from one
    ``torch.Generator``, which must live on ``device``).  ``dtype`` casts
    every floating leaf as it is made (the serving engine holds weights in
    the compute dtype); None keeps each spec's own dtype.  The draws differ
    from the JAX package's threefry init — parity tests carry JAX weights
    across with ``repro_torch.convert.from_jax_params`` instead."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return _init_one(t, gen, device,
                         torch_dtype(dtype or t.dtype))
    return walk(spec_tree)


def cast_tree(tree, dtype):
    """Cast every floating leaf to ``dtype`` (a no-op for leaves already in
    it, so weights held in the compute dtype are never copied)."""
    d = torch_dtype(dtype)
    return tree_map(lambda x: x.to(d) if x.is_floating_point() else x, tree)


# ---------------------------------------------------------------------------
# Shared numerics
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def norm_specs(cfg, shape_prefix=(), axes_prefix=()):
    """Norm params for one layer position (stacked over layers)."""
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": ParamSpec(shape_prefix + (d,), axes_prefix + ("embed2",), init="ones"),
            "bias": ParamSpec(shape_prefix + (d,), axes_prefix + ("embed2",), init="zeros"),
        }
    return {"scale": ParamSpec(shape_prefix + (d,), axes_prefix + ("embed2",), init="zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# --- RoPE ------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Half-split
    rotation in fp32, cast back to x.dtype."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(hd, theta)).to(x.device)
    angles = positions[..., :, None].float() * freqs           # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                   # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation; so does the port
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "silu": F.silu,
        "swiglu": F.silu,    # gate activation used inside SwiGLU
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


def dot(x, w, compute_dtype=None):
    """Linear apply with dtype management: operands in the compute dtype,
    fp32 accumulation (what torch.matmul does for bf16), result cast back."""
    cd = torch_dtype(compute_dtype) if compute_dtype is not None else x.dtype
    return torch.matmul(x.to(cd), w.to(cd)).to(cd)
