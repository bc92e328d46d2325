"""Gradient reduction strategies — the paper's MPI_Allreduce operator
(its §III-D.2) on ``torch.distributed``.

The port of ``src/repro/core/allreduce.py``.  Every strategy computes the
same mean over the data-parallel (DP) replicas; they differ in collective
granularity and schedule, which is what the paper's "layer-wise ordered
all-to-all reduction" is about:

  fused          one all-reduce of one flat fp32 vector
  layerwise      one all-reduce per parameter tensor, back to front — the
                 paper's design
  bucketed       layerwise coalesced into ~bucket_bytes buckets
  hierarchical   mean over the intra-pod subgroup, then across pods
  compressed     bf16 wire format with fp32 error feedback (beyond-paper)

The ZeRO-1 ``reduce_scatter`` strategy lives in transparent.py because it
fuses with the optimizer update.

Gradients are nested dicts of fp32 tensors; their leaf order is the JAX
pytree order (sorted keys), so "reverse order" and the bucket partition
are the JAX package's.  Reductions are in place: each leaf (or a flat
bucket copied back into the leaves) is all-reduced where it lies.  A
``DPGroup`` without a process group (world size 1) makes every collective
the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map


@dataclass(frozen=True)
class DPGroup:
    """The data-parallel replicas a reduction averages over.

    ``group`` is the torch process group of all DP ranks (None: world size
    1 and no process group — collectives are identities); ``size`` its
    world size.  ``inner`` / ``outer`` are this rank's intra-pod and
    cross-pod subgroups for ``hierarchical`` (None when the mesh has no
    pod axis, or for other strategies)."""
    group: Any = None
    size: int = 1
    inner: Any = None
    outer: Any = None

    @property
    def active(self) -> bool:
        return self.group is not None


SINGLE = DPGroup()


def mean_(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """All-reduce mean of ``x`` over ``group``, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.div_(size)


def _group_size(group) -> int:
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

def _flat_mean_(leaves, dp: DPGroup):
    """Copy ``leaves`` into one fp32 vector, average it, copy it back."""
    flat = torch.cat([l.float().reshape(-1) for l in leaves])
    mean_(flat, dp.group, dp.size)
    off = 0
    for l in leaves:
        n = l.numel()
        l.copy_(flat[off:off + n].view(l.shape))
        off += n


def fused_allreduce(grads, dp: DPGroup):
    """Single collective over one concatenated fp32 vector."""
    _flat_mean_(tree_leaves(grads), dp)
    return grads


def layerwise_allreduce(grads, dp: DPGroup):
    """One all-reduce per tensor, in reverse tree order (gradients become
    available back to front during backprop — the paper's ordered list)."""
    for l in reversed(tree_leaves(grads)):
        mean_(l, dp.group, dp.size)
    return grads


def bucket_partition(sizes, bucket_bytes: int):
    """Leaf indices in reverse order, cut into ~bucket_bytes fp32 buckets
    (a leaf larger than a bucket gets one of its own)."""
    buckets, cur, cur_bytes = [], [], 0
    for i in range(len(sizes) - 1, -1, -1):
        n = sizes[i] * 4
        if cur and cur_bytes + n > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += n
    if cur:
        buckets.append(cur)
    return buckets


def bucketed_allreduce(grads, dp: DPGroup, bucket_bytes: int):
    """Coalesce tensors (in reverse order) into ~bucket_bytes buckets."""
    leaves = tree_leaves(grads)
    for bucket in bucket_partition([l.numel() for l in leaves], bucket_bytes):
        if len(bucket) == 1:
            mean_(leaves[bucket[0]], dp.group, dp.size)
        else:
            _flat_mean_([leaves[i] for i in bucket], dp)
    return grads


def hierarchical_allreduce(grads, dp: DPGroup):
    """Mean over the intra-pod subgroup first, then across pods — the MPI
    analogue is a node-local reduce followed by an inter-node allreduce.
    Without a pod axis it is one all-reduce over all DP ranks; with one
    replica a pod (no intra-pod subgroup) only the cross-pod one."""
    inner = dp.inner if dp.inner is not None or dp.outer is not None \
        else dp.group
    for l in tree_leaves(grads):
        if inner is not None:
            mean_(l, inner, _group_size(inner))
        if dp.outer is not None:
            mean_(l, dp.outer, _group_size(dp.outer))
    return grads


def compressed_allreduce(grads, err, dp: DPGroup):
    """bf16 wire format with fp32 error feedback (beyond-paper).

    err: fp32 tree of residuals from previous steps (same structure),
    updated in place.  Returns (reduced fp32 grads, err)."""
    def one(g, e):
        g32 = g.float() + e
        wire = g32.to(torch.bfloat16)
        e.copy_(g32 - wire.float())
        mean_(wire, dp.group, dp.size)
        return wire.float()

    return _map2(one, grads, err), err


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def reduce_gradients(grads, strategy: str, dp: DPGroup,
                     bucket_bytes: int = 32 << 20, err=None):
    """Apply a reduction strategy; returns (fp32 grads, new_err_or_None)."""
    grads = tree_map(lambda g: g.float(), grads)
    if not dp.active:
        return grads, err
    if strategy == "fused":
        return fused_allreduce(grads, dp), err
    if strategy == "layerwise":
        return layerwise_allreduce(grads, dp), err
    if strategy == "bucketed":
        return bucketed_allreduce(grads, dp, bucket_bytes), err
    if strategy == "hierarchical":
        return hierarchical_allreduce(grads, dp), err
    if strategy == "compressed":
        if err is None:
            raise ValueError("compressed strategy needs an error-feedback "
                             "tree (init_error_tree)")
        return compressed_allreduce(grads, err, dp)
    raise ValueError(f"unknown strategy {strategy!r}")


def init_error_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
