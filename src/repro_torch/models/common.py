"""Parameter-spec system + shared layer primitives (PyTorch).

Every model in ``repro_torch.models`` is functional, as in the JAX package:

  ``param_specs(cfg) -> tree[ParamSpec]``   (nested dicts of specs)
  ``apply(cfg, params, inputs, ...) -> outputs``

Parameters are nested dicts of tensors keyed exactly like the JAX
package's pytree (stacked ``[L, ...]`` layer leaves included), so weights
carry across key for key (``repro_torch.convert.from_jax_params``).

Sharding rules map each spec's logical axes to mesh axes (``rules_for``,
``spec_to_pspec``: the JAX package's, with the whole-head rule below).  A
placement is a tuple with one entry per dim: None (replicated), an axis
name, or a tuple of axis names (the JAX ``PartitionSpec``'s entries).

Tensor parallelism (the mesh's "model" axis) runs the model functions on
plain local shards, one process per mesh device: while a ``model_axis``
context is active, ``local_extent`` gives the local head / channel counts
and the collective points stand where GSPMD inserts its collectives in the
JAX package (``maybe_wsc`` and the sharded einsums there):

  * ``to_model``     — the entry of a column-parallel region: identity
    forward, all-reduce backward (Megatron's "copy to model region");
  * ``from_model``   — the exit of a row-parallel region (after ``wo``,
    the MLP / RG-LRU / WKV output projections and the expert-parallel
    combine): all-reduce forward in fp32, identity backward;
  * ``gather_model`` — vocab-sharded logits before argmax / sampling /
    the loss, and the RG-LRU gate input: all-gather of the last dim.

The kernels take plain tensors, so every kernel call is unchanged, at the
local head or channel count: what a ``shard_map`` region does around a
Pallas call.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, FrozenSet, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
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
# Sharding rules (logical axis -> mesh axis)
# ---------------------------------------------------------------------------

# Default logical-axis -> mesh-axis rules (Megatron-style TP on "model");
# "embed" maps to the DP axes in fsdp mode (see rules_for).
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("vocab", "model"),
    ("heads", "model"),        # fused head*head_dim projections
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("expert", "model"),       # expert-parallel when divisible
    ("expert_mlp", None),      # per-arch override may set "model"
    ("lru", "model"),
    ("lru_in", None),          # input dim of square LRU gate matrices
    ("embed", None),
    ("embed2", None),          # second d_model-sized axis (e.g. wo output)
    ("layers", None),
    ("window", None),
    ("rank", None),            # low-rank/LoRA dims (MLA kv_lora, rwkv decay)
)


def _model_dims(model_cfg) -> dict:
    """The whole-unit count behind each model-sharded logical axis."""
    dims = {"heads": model_cfg.num_heads, "kv_heads": model_cfg.num_kv_heads,
            "mlp": model_cfg.d_ff, "vocab": model_cfg.vocab_size}
    if model_cfg.moe is not None:
        m = model_cfg.moe
        if m.num_shared_experts:          # the shared experts' "mlp"
            dims["mlp"] = m.d_ff_shared or m.d_ff_expert * m.num_shared_experts
        dims["expert"] = m.held
        dims["expert_mlp"] = m.d_ff_expert
    if model_cfg.rglru is not None:
        dims["lru"] = model_cfg.rglru.lru_width or model_cfg.d_model
    if model_cfg.rwkv is not None:
        dims["heads"] = model_cfg.d_model // model_cfg.rwkv.head_size
    return dims


def rules_for(mesh_cfg, model_cfg=None) -> dict:
    """Resolve sharding rules for a (mesh, model) pair.

    fsdp mode shards the "embed" (d_model) weight dimension over every DP
    axis (pod included).  With ``model_cfg`` the MoE expert-parallel rule
    applies (experts over "model" only when their count divides it, else
    ``expert_mlp``), and so does the port's **whole-head rule**: a fused
    head dim shards only on whole heads — ``heads`` when the head count
    divides the model axis and the KV heads either do too or are one
    (each rank's query heads then read whole KV heads), ``kv_heads`` when
    the KV head count divides it — and every other model-sharded axis
    only when its extent divides the axis.  Otherwise the axis replicates:
    values stay the same, only the placement differs (the JAX package's
    rules shard such dims anyway and GSPMD pads them).
    """
    rules = dict(DEFAULT_RULES)
    if mesh_cfg.dp_mode == "fsdp":
        dp = tuple(a for a in mesh_cfg.axis_names if a in ("pod", "data"))
        rules["embed"] = dp if len(dp) > 1 else "data"
    for k, v in mesh_cfg.rules_override:
        rules[k] = v
    if model_cfg is None:
        return rules
    msize = 1
    for s, a in zip(mesh_cfg.shape, mesh_cfg.axis_names):
        if a == "model":
            msize = s
    if model_cfg.moe is not None \
            and model_cfg.moe.held % max(msize, 1) != 0:
        rules["expert"] = None
        rules["expert_mlp"] = "model"
    if msize > 1:
        dims = _model_dims(model_cfg)
        for axis, n in dims.items():
            if rules.get(axis) == "model" and n % msize:
                rules[axis] = None
        kv = model_cfg.num_kv_heads
        if model_cfg.rwkv is None and kv % msize and kv != 1:
            rules["heads"] = None
    return rules


#: families whose model code carries the collective points; the others
#: (encdec, vlm, cnn) replicate over "model", each model rank computing
#: the whole layer
TP_FAMILIES = ("dense", "moe", "hybrid", "ssm")


def model_sharded_axes(rules: dict, model_cfg=None) -> FrozenSet[str]:
    """The logical axes the rules put on "model" (none for a family
    without the collective points, or without a model config)."""
    if model_cfg is None or model_cfg.family not in TP_FAMILIES:
        return frozenset()
    return frozenset(a for a, m in rules.items() if m == "model")


def spec_to_pspec(spec: ParamSpec, rules: dict) -> tuple:
    """Logical axes -> placement tuple under the given rules."""
    return tuple(rules.get(a) if a is not None else None for a in spec.axes)


def logical_to_mesh(spec_tree, rules: dict):
    """ParamSpec tree -> placement tree (the JAX package's NamedSharding
    tree; ``launch.mesh.ProcessMesh`` applies a placement to a tensor)."""
    return tree_map(lambda s: spec_to_pspec(s, rules), spec_tree)


def manual_axis_specs(spec_tree, rules: dict, manual_axes: Tuple[str, ...]):
    """Placements *restricted to* ``manual_axes`` — the entries an
    explicit collective handles (the DP axes of an fsdp leaf, which the
    trainer gathers); the rest are the model axis's."""
    def one(s: ParamSpec):
        out = []
        for a in s.axes:
            m = rules.get(a) if a is not None else None
            if isinstance(m, tuple):
                kept = tuple(x for x in m if x in manual_axes)
                out.append(kept if kept else None)
            else:
                out.append(m if m in manual_axes else None)
        return tuple(out)
    return tree_map(one, spec_tree)


# ---------------------------------------------------------------------------
# Tensor parallelism: the model axis of this process
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelAxis:
    """This process's place on the mesh's "model" axis: the process group
    of the ranks that share its data coordinates, its size and rank in
    it, and the logical axes the rules put on "model"."""
    group: Any
    size: int
    rank: int
    sharded: FrozenSet[str]


#: the axis the model functions run under; set only through ``model_axis``
#: (as the JAX package's ``activation_batch_axes`` sets its global around
#: tracing), so every model entry point keeps its one-device signature
_MODEL_AXIS: Optional[ModelAxis] = None


@contextlib.contextmanager
def model_axis(axis: Optional[ModelAxis]):
    """Run the model functions on this rank's shards (None: unsharded)."""
    global _MODEL_AXIS
    old, _MODEL_AXIS = _MODEL_AXIS, axis
    try:
        yield
    finally:
        _MODEL_AXIS = old


def _sharded(axis: str) -> Optional[ModelAxis]:
    ax = _MODEL_AXIS
    return ax if ax is not None and ax.size > 1 and axis in ax.sharded \
        else None


def local_extent(n: int, axis: str) -> int:
    """The local count of ``n`` units (heads, channels) on ``axis``."""
    ax = _sharded(axis)
    return n // ax.size if ax is not None else n


def local_offset(n: int, axis: str) -> int:
    """The first of this rank's ``local_extent(n, axis)`` units."""
    ax = _sharded(axis)
    return ax.rank * (n // ax.size) if ax is not None else 0


def local_chunk(x, axis: str, dim: int = -1):
    """This rank's contiguous chunk of a tensor that is whole on every
    rank (a replicated leaf read per head)."""
    ax = _sharded(axis)
    if ax is None:
        return x
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


def _all_reduce_fp32(x, group):
    y = x.float().contiguous()          # clone: never reduce in place
    if y is x:
        y = y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


def _all_gather_last(x, group, size: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_fp32(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.n, ctx.rank = x.shape[-1], rank
        return _all_gather_last(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n).contiguous(), \
            None, None, None


def to_model(x, axis: str):
    """Entry of a column-parallel region over ``axis``: identity forward,
    all-reduce of the gradient backward.  Also wraps a replicated weight
    (or a replicated activation read per head) used inside the region, so
    its partial per-rank gradient sums to the whole one."""
    ax = _sharded(axis)
    if ax is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ToModel.apply(x, ax.group)


def from_model(x, axis: str):
    """Exit of a row-parallel region over ``axis``: the partial sums of the
    ranks all-reduced (in fp32, cast back), identity backward."""
    ax = _sharded(axis)
    if ax is None:
        return x
    return _FromModel.apply(x, ax.group)


def gather_model(x, axis: str):
    """All-gather of a last dim sharded over ``axis`` (backward: this
    rank's chunk of the gradient, which every rank holds whole)."""
    ax = _sharded(axis)
    if ax is None:
        return x
    return _GatherModel.apply(x, ax.group, ax.size, ax.rank)


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
                dtype=None, keep=None):
    """Materialize a ParamSpec tree (leaves in sorted-key order from one
    ``torch.Generator``, which must live on ``device``).  ``dtype`` casts
    every floating leaf as it is made (the serving engine holds weights in
    the compute dtype); None keeps each spec's own dtype.  The draws differ
    from the JAX package's threefry init — parity tests carry JAX weights
    across with ``repro_torch.convert.from_jax_params`` instead.
    ``keep`` maps each leaf as it is made, in that order (a mesh rank
    keeps its block: ``launch.sharding.init_local_params``)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        x = _init_one(t, gen, device, torch_dtype(dtype or t.dtype))
        return x if keep is None else keep(x)
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


#: (head_dim, theta, device) -> the rotation frequencies on a CUDA device
_ROPE_FREQS: dict = {}


def _rope_freqs(hd: int, theta: float, device):
    """``rope_frequencies`` on ``device``; on a CUDA device copied there
    once and kept, so a decode step launches no host-to-device copy (none
    may run while the engine captures its decode graph).  Fake tensors
    (the dry run) are never kept."""
    freqs = torch.from_numpy(rope_frequencies(hd, theta))
    if device.type != "cuda":
        return freqs.to(device)
    key = (hd, theta, device)
    if key not in _ROPE_FREQS:
        on_device = freqs.to(device)
        if type(on_device) is not torch.Tensor:
            return on_device
        _ROPE_FREQS[key] = on_device
    return _ROPE_FREQS[key]


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Half-split
    rotation in fp32, cast back to x.dtype."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
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
