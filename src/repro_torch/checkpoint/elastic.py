"""Elastic restore: resume a run at another data-parallel degree.

The port of ``src/repro/checkpoint/elastic.py``.  The paper's §III-B
argument — "by using data parallelism the critical data structures are
automatically replicated for fault tolerance" — as a mechanism: the
trainer's canonical state (whole params and optimizer trees — gathered
from their model- and fsdp-shards — and ZeRO-1 optimizer state in its
global ``[dp, shard]`` layout) restores onto a trainer of another mesh,
each rank keeping its blocks (``TransparentTrainer.load_state``), the flat
ZeRO-1 leaves re-padded and re-split when the DP degree changed.  In the
port a mesh device is a process (``launch.mesh``), so "a smaller mesh"
is fewer processes, started anew, each calling ``restore_elastic``.  With
checkpoint.py this is ULFM-style continued execution: lose a replica,
restart smaller, restore, keep training (``failures.run_with_recovery``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (latest_step, leaf_items,
                                               load_leaves, read_manifest,
                                               restore_checkpoint,
                                               unflatten_like)
from repro_torch.configs.base import MeshConfig


def shrink_mesh_config(mesh_cfg: MeshConfig, lost_replicas: int = 1) -> MeshConfig:
    """Drop data-parallel replicas (the failure-absorbing axis)."""
    shape = list(mesh_cfg.shape)
    for i, a in enumerate(mesh_cfg.axis_names):
        if a == "data":
            new = shape[i] - lost_replicas
            if new < 1:
                raise ValueError("cannot shrink below one data replica")
            shape[i] = new
    return dataclasses.replace(mesh_cfg, shape=tuple(shape))


def rebatch_for_mesh(global_batch: int, old_dp: int, new_dp: int,
                     keep_global: bool = True) -> int:
    """Elastic batch policy: keep the global batch (per-replica grows) or
    keep the per-replica batch (the global one shrinks — changes the
    optimization slightly, which the supervisor must log)."""
    if keep_global:
        if global_batch % new_dp:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {new_dp} replicas")
        return global_batch
    per = global_batch // old_dp
    return per * new_dp


def restore_elastic(ckpt_dir, trainer, *, step: Optional[int] = None):
    """Restore a checkpoint onto ``trainer`` (possibly of another DP
    degree): returns (this rank's TrainState, step).  A flat ZeRO-1 leaf
    saved as ``[dp_old, n/dp_old]`` is read as its flat vector, zero-padded
    or cut to ``[dp_new, n/dp_new]`` (the tail is padding: zero gradients
    keep the moments there at zero) and split by rank."""
    like = trainer.state_structs()
    s = step if step is not None else latest_step(ckpt_dir)
    if s is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    saved = [tuple(x) for x in read_manifest(ckpt_dir, s)["shapes"]]
    items = leaf_items(like)
    if [tuple(l.shape) for _, l in items] == saved:
        tree, s = restore_checkpoint(ckpt_dir, like, step=s)
        return trainer.load_state(tree), s
    raw = load_leaves(ckpt_dir, s)
    if len(raw) != len(items):
        raise ValueError(f"checkpoint has {len(raw)} leaves, the trainer "
                         f"{len(items)}")
    leaves = []
    for arr, (path, ref) in zip(raw, items):
        want = tuple(ref.shape)
        if tuple(arr.shape) != want:
            if not (arr.ndim == 2 and len(want) == 2
                    and arr.shape[0] != want[0]):
                raise ValueError(f"cannot reconcile leaf {path!r} "
                                 f"{arr.shape} -> {want}")
            flat = arr.reshape(-1)
            n = want[0] * want[1]
            arr = np.pad(flat, (0, max(0, n - flat.size)))[:n].reshape(want)
        leaves.append(torch.from_numpy(arr))
    return trainer.load_state(unflatten_like(like, leaves)), s
