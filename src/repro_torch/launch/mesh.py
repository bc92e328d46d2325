"""Process meshes: one process per mesh device.

The port of ``src/repro/launch/mesh.py``.  ``jax.make_mesh`` lays a
``MeshConfig`` over the devices of one program; here every device of the
mesh is one process of the default ``torch.distributed`` group (NCCL on
the card, gloo on the CPU), and ``build_mesh`` makes the process
subgroups the collectives run over.  Ranks are linear over the axes in
mesh order — ``pod`` outer, ``model`` innermost — as ``jax.make_mesh``
lays devices out, so with a ``data x model`` mesh of 2x2 the model groups
are ``{0, 1}`` and ``{2, 3}`` and the data groups ``{0, 2}`` and
``{1, 3}``.

A placement (``models.common.spec_to_pspec``: one entry per dim, None or
axis names) applies to a tensor through ``ProcessMesh.local`` (this rank's
block; DTensor's ``Shard(d)`` per named dim, ``Replicate()`` elsewhere) and
``ProcessMesh.full`` (the all-gather back).  Nothing here touches device
state at import.
"""
from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig

DP_AXES = ("pod", "data")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class ProcessMesh:
    """The mesh of ``cfg`` over the processes of the default group (or one
    process without a group, for a one-device mesh).  Every rank builds
    every subgroup, in the same order, as ``dist.new_group`` requires;
    ``group(axes)`` is this rank's (None when it has one member)."""

    def __init__(self, cfg: MeshConfig):
        cfg.validate()
        self.cfg = cfg
        self.shape = tuple(cfg.shape)
        self.axis_names = tuple(cfg.axis_names)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != cfg.num_devices:
            raise ValueError(
                f"mesh {'x'.join(map(str, self.shape))} has "
                f"{cfg.num_devices} devices but "
                + (f"the process group has {world}" if dist.is_initialized()
                   else "no process group is up")
                + f": start {cfg.num_devices} processes and call "
                "torch.distributed.init_process_group in each")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords: Dict[str, int] = {}
        r = self.rank
        for name, size in reversed(list(zip(self.axis_names, self.shape))):
            self.coords[name] = r % size
            r //= size
        self._groups: Dict[Tuple[str, ...], object] = {}
        if world > 1:
            # every subset of axes, in mesh order; within a subset the
            # groups in order of the other axes' coordinates
            names = self.axis_names
            for n in range(1, len(names) + 1):
                for sub in itertools.combinations(names, n):
                    if self.size(sub) > 1:
                        self._build_groups(sub)

    # -- geometry ----------------------------------------------------------

    def size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            if a in self.axis_names:
                n *= self.shape[self.axis_names.index(a)]
        return n

    def index(self, axes) -> int:
        """This rank's linear index over ``axes`` (in the order given)."""
        i = 0
        for a in _axes(axes):
            if a in self.axis_names:
                i = i * self.shape[self.axis_names.index(a)] + self.coords[a]
        return i

    def _linear(self, coords: Dict[str, int]) -> int:
        r = 0
        for name, size in zip(self.axis_names, self.shape):
            r = r * size + coords[name]
        return r

    def _build_groups(self, sub: Tuple[str, ...]):
        others = [a for a in self.axis_names if a not in sub]
        ranges = lambda axes: itertools.product(
            *(range(self.shape[self.axis_names.index(a)]) for a in axes))
        for fixed in ranges(others):
            base = dict(zip(others, fixed))
            ranks = sorted(self._linear({**base, **dict(zip(sub, c))})
                           for c in ranges(sub))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[tuple(sub)] = g

    def group(self, axes):
        """This rank's process group over ``axes`` (mesh order), None
        when it has one member."""
        key = tuple(a for a in self.axis_names if a in _axes(axes))
        return self._groups.get(key)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in DP_AXES)

    # -- placements --------------------------------------------------------

    def local(self, t: torch.Tensor, pspec) -> torch.Tensor:
        """This rank's block of ``t`` (whole on every rank) under
        ``pspec`` — a view; a dim whose extent does not divide its axes
        raises (the rules replicate such dims)."""
        for dim, entry in enumerate(pspec):
            n = self.size(entry)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide mesh axes {_axes(entry)} ({n})")
            k = t.shape[dim] // n
            t = t.narrow(dim, self.index(entry) * k, k)
        return t

    def full(self, t: torch.Tensor, pspec) -> torch.Tensor:
        """The inverse of ``local``: the blocks of every rank all-gathered
        (a collective over each sharded dim's group; every rank calls)."""
        for dim in reversed(range(len(pspec))):
            entry = pspec[dim]
            n = self.size(entry)
            if n == 1:
                continue
            # a group's members, in rank order, are its linear indices
            # over the entry's axes when those are in mesh order
            order = [a for a in self.axis_names if a in _axes(entry)]
            if list(_axes(entry)) != order:
                raise ValueError(f"placement entry {entry} is not in mesh "
                                 f"order {self.axis_names}")
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=self.group(entry))
            t = torch.cat(parts, dim=dim)
        return t

    def __repr__(self):
        return (f"ProcessMesh({'x'.join(map(str, self.shape))}, "
                f"{self.axis_names}, rank={self.rank})")


def build_mesh(cfg: MeshConfig) -> ProcessMesh:
    """Mesh from an arbitrary MeshConfig; the world size must be
    ``cfg.num_devices``."""
    return ProcessMesh(cfg)


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """Production mesh: 16x16 (256 devices) or 2x16x16 (two pods) — as
    many processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(MeshConfig(shape=shape, axis_names=axes))


def mesh_config_for(mesh: ProcessMesh) -> MeshConfig:
    return MeshConfig(shape=tuple(mesh.shape),
                      axis_names=tuple(mesh.axis_names))


def dp_size(mesh_cfg: MeshConfig) -> int:
    n = 1
    for s, a in zip(mesh_cfg.shape, mesh_cfg.axis_names):
        if a in DP_AXES:
            n *= s
    return n


def model_size(mesh_cfg: MeshConfig) -> int:
    n = 1
    for s, a in zip(mesh_cfg.shape, mesh_cfg.axis_names):
        if a == "model":
            n *= s
    return n
