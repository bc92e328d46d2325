"""Shared CLI plumbing for the port's launchers: the flags in front of
``repro_torch.api``.

Every launcher takes ``--arch/--smoke/--mesh/--seed/--device`` and asks for
a ``Session``; each adds its workload's flags.  The port has no
placeholder devices, so the reference's ``--devices`` becomes ``--device
{cuda,cpu}``.  ``--mesh D``, ``DxM`` or ``PxDxM`` is a mesh of as many
processes (``D·M``, ``P·D·M``) of one ``torch.distributed`` process group,
one per mesh device, started by

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train ... --mesh 2x2

``make_session`` checks the mesh's device count against ``WORLD_SIZE``,
joins the group (gloo on the CPU, NCCL on CUDA) and passes the mesh to
``api.load``; without ``--mesh`` the mesh is ``WORLD_SIZE`` data-parallel
replicas (1 when unset).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

from repro_torch.api.session import parse_mesh as _parse_mesh_cfg


def parse_mesh(spec: str) -> Tuple[int, ...]:
    """``"D"`` / ``"DxM"`` / ``"PxDxM"`` -> the extents; a 1-D spec gets a
    model axis of 1 (pure data parallelism, the paper's setting).  The
    one parser is ``repro_torch.api.parse_mesh``."""
    return tuple(_parse_mesh_cfg(spec).shape)


def add_session_flags(ap: argparse.ArgumentParser, *,
                      arch_default: str = "qwen2.5-14b"):
    """The flags every Session-backed launcher shares."""
    ap.add_argument("--arch", default=arch_default)
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-sized config variant")
    ap.add_argument("--mesh", default=None, type=_mesh_arg,
                    help="'D', 'DxM' or 'PxDxM': one process of one "
                    "process group per mesh device (start D·M of them "
                    "with torch.distributed.run --nproc-per-node D·M); "
                    "default: WORLD_SIZE data-parallel replicas, 1 when "
                    "unset")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (cpu: the kernels' plain "
                         "PyTorch versions)")
    return ap


def _mesh_arg(spec: str):
    try:
        return parse_mesh(spec)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def mesh_devices(mesh: Optional[Tuple[int, ...]]) -> int:
    """The process count of a parsed ``--mesh`` (``WORLD_SIZE`` without
    one)."""
    if mesh is None:
        return int(os.environ.get("WORLD_SIZE", "1"))
    n = 1
    for s in mesh:
        n *= s
    return n


def init_process_group(args) -> int:
    """Join the process group of a multi-process run started by
    ``torch.distributed.run``; returns its size."""
    import torch
    import torch.distributed as dist
    n = mesh_devices(args.mesh)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n != world:
        raise ValueError(
            f"--mesh asks for {n} processes but WORLD_SIZE is {world}: start "
            f"them with python -m torch.distributed.run --standalone "
            f"--nproc-per-node {n} -m <launcher> ...")
    if n > 1 and not dist.is_initialized():
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                                init_method="env://", world_size=n,
                                rank=int(os.environ["RANK"]))
    return n


def make_session(args, **load_kw):
    """Join the run's process group, then build the Session the launcher
    runs against (on the ``--mesh`` given)."""
    init_process_group(args)
    from repro_torch import api
    mesh = None if args.mesh is None else "x".join(map(str, args.mesh))
    return api.load(args.arch, smoke=args.smoke, seed=args.seed,
                    device=args.device, mesh=mesh, **load_kw)
