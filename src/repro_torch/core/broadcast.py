"""Broadcast operator — the paper's §III-D.1.

The port of ``src/repro/core/broadcast.py``.  MaTEx-TensorFlow guarantees
that every replica starts from identical variables by broadcasting rank
0's initial model.  The JAX package expresses that as a masked psum inside
its SPMD region; here it is ``dist.broadcast`` from rank 0 of the DP
process group, leaf by leaf, in place.

This is not redundant with same-seed initialization: it makes replica
consistency unconditional (non-deterministic per-host init, a restored
checkpoint with host-local corruption, a fresh replica joining).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.allreduce import DPGroup
from repro_torch.models.common import tree_leaves


def _root(dp: DPGroup) -> int:
    """Global rank of the group's rank 0."""
    return dist.get_global_rank(dp.group, 0)


def broadcast_masked(tree, dp: DPGroup, mask: bool):
    """Masked-sum broadcast: the replica(s) where ``mask`` is True
    contribute, everyone receives the sum (in place).  ``mask`` carries
    rank identity as data, as the JAX package's version does."""
    if not dp.active:
        return tree
    for x in tree_leaves(tree):
        contrib = x.float() if mask else torch.zeros_like(x, dtype=torch.float32)
        dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=dp.group)
        x.copy_(contrib)
    return tree


def broadcast_from_rank0(tree, dp: DPGroup):
    """Replace every leaf with rank 0's, in place."""
    if not dp.active:
        return tree
    src = _root(dp)
    for x in tree_leaves(tree):
        dist.broadcast(x, src=src, group=dp.group)
    return tree


def replicas_identical(tree, dp: DPGroup) -> float:
    """Consistency check: max |x - rank0(x)| over all leaves and replicas
    (0.0 == identical); every rank gets the same value."""
    if not dp.active:
        return 0.0
    src = _root(dp)
    worst = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for x in tree_leaves(tree):
        ref = x.detach().clone()
        dist.broadcast(ref, src=src, group=dp.group)
        worst = torch.maximum(worst, (x.float() - ref.float()).abs().max())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=dp.group)
    return float(worst)
