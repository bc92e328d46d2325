"""Placements of parameters, serve-side state (KV caches / recurrent
states) and inputs over a process mesh.

The port of ``src/repro/launch/sharding.py``.  A placement is a tuple
with one entry per dim (None, or mesh axis names): the JAX package's
``PartitionSpec`` entries.  Every rule is divisibility-guarded, and the
port shards a head dim only on whole heads: where the KV-head count does
not divide the model axis the cache leaf replicates (the JAX rules shard
``head_dim`` instead, and GSPMD inserts the score psum; the port's
attention runs on whole local heads, so it has no such split).

Cache leaves are name-matched (the trees are ours, names are stable):
  k/v        [L, B, Lc, KV, hd]   batch->dp; KV->model
  ckv/krope  [L, B, Lc, R]        batch->dp; R->model when divisible
  s          [L, B, H, hd, hd]    batch->dp; heads->model (wkv state)
  h          [n, B, W]            batch->dp; lru width->model
  conv       [n, B, cw-1, W]      batch->dp; width->model
  x / cm     [L, B, D]            batch->dp
  enc        [B, T, D]            batch->dp
  pos/index  replicated

``param_rules`` / ``model_axis_for`` / ``init_local_params`` are the
runtime side: the rules a run places its parameters by, this process's
``ModelAxis`` and its parameter shards drawn from the one-process init.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.common import (ModelAxis, init_params,
                                       logical_to_mesh, model_sharded_axes,
                                       rules_for, tree_leaves)


def _map_named(fn, tree, name=None):
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def _dp(dp_axes: Tuple[str, ...], batch: int, dp_total: int):
    if not dp_axes or batch <= 1 or batch % max(dp_total, 1) != 0:
        return None
    return tuple(dp_axes)


def serve_state_pspecs(state_structs, *, dp_axes: Tuple[str, ...],
                       dp_total: int, model_size: int):
    """Placement tree matching a decode-state tree (tensors or meta
    tensors)."""

    def _model(dim_size: int):
        return "model" if model_size > 1 and dim_size % model_size == 0 \
            else None

    def rule(name, leaf):
        nd = leaf.ndim
        if name in ("pos", "index") or nd <= 1:
            return (None,) * nd
        # batch dim position: stacked trees put it at dim 1; "enc" at dim 0
        bdim = 0 if name == "enc" else 1
        batch = leaf.shape[bdim] if nd > bdim else 1
        dp = _dp(dp_axes, batch, dp_total)
        spec = [None] * nd
        if dp is not None:
            spec[bdim] = dp
        if name in ("k", "v") and nd == 5:
            spec[3] = _model(leaf.shape[3])
        elif name in ("ckv", "krope") and nd == 4:
            spec[3] = _model(leaf.shape[3])
        elif name == "s" and nd == 5:
            spec[2] = _model(leaf.shape[2])
        elif name == "h" and nd == 3:
            spec[2] = _model(leaf.shape[2])
        elif name == "conv" and nd == 4:
            spec[3] = _model(leaf.shape[3])
        return tuple(spec)

    return _map_named(rule, state_structs)


def serve_input_pspecs(input_structs, *, dp_axes: Tuple[str, ...],
                       dp_total: int):
    def rule(_, leaf):
        if leaf.ndim == 0:
            return ()
        dp = _dp(dp_axes, leaf.shape[0], dp_total)
        return (dp,) + (None,) * (leaf.ndim - 1)
    return _map_named(rule, input_structs)


def with_shardings(structs, pspecs, mesh):
    """Meta tensors at each leaf's local shape on ``mesh`` (the JAX
    package's sharded ``ShapeDtypeStruct`` tree)."""
    def one(st, sp):
        shape = list(st.shape)
        for d, entry in enumerate(sp):
            shape[d] //= mesh.size(entry)
        return torch.empty(shape, dtype=st.dtype, device="meta")
    if isinstance(structs, dict):
        return {k: with_shardings(structs[k], pspecs[k], mesh)
                for k in structs}
    return one(structs, pspecs)


# ---------------------------------------------------------------------------
# Runtime: the rules a run places its parameters by
# ---------------------------------------------------------------------------

def param_rules(mesh_cfg, model_cfg=None):
    """(rules, model-sharded logical axes) a run places its parameters
    by: ``rules_for`` with "model" dropped from every axis the model code
    does not shard (``models.common.TP_FAMILIES``)."""
    rules = rules_for(mesh_cfg, model_cfg)
    sharded = model_sharded_axes(rules, model_cfg)
    return ({k: (None if v == "model" and k not in sharded else v)
             for k, v in rules.items()}, sharded)


def model_axis_for(mesh, sharded) -> ModelAxis:
    """This rank's ``ModelAxis`` on ``mesh``."""
    return ModelAxis(group=mesh.group(("model",)), size=mesh.size("model"),
                     rank=mesh.index("model"), sharded=frozenset(sharded))


def init_local_params(specs, rules, mesh, gen: torch.Generator, *,
                      device, dtype=None):
    """This rank's parameter shards: the one-process init from ``gen``
    (the same draws, leaf by leaf), each leaf cut to its block at once so
    the whole tree never exists on the rank."""
    placements = logical_to_mesh(specs, rules)
    flat = iter(tree_leaves(placements))
    return init_params(specs, gen, device=device, dtype=dtype,
                       keep=lambda x: mesh.local(x, next(flat)).clone())


def local_tree(tree, placements, mesh):
    """Blocks of a tree that is whole on every rank (copies)."""
    if isinstance(tree, dict):
        return {k: local_tree(tree[k], placements[k], mesh) for k in tree}
    return mesh.local(tree, placements).clone()


def full_tree(tree, placements, mesh):
    """The inverse of ``local_tree`` (a collective: every rank calls)."""
    if isinstance(tree, dict):
        return {k: full_tree(tree[k], placements[k], mesh) for k in tree}
    return mesh.full(tree, placements)
