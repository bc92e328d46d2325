"""Shared CLI plumbing for the port's launchers: the flags in front of
``repro_torch.api``.

Every launcher takes ``--arch/--smoke/--mesh/--seed/--device`` and asks for
a ``Session``; each adds its workload's flags.  The port has no
placeholder devices, so the reference's ``--devices`` becomes ``--device
{cuda,cpu}``.  ``--mesh D`` (or ``Dx1``) is D data-parallel processes of
one ``torch.distributed`` process group, started by

    python -m torch.distributed.run --standalone --nproc-per-node D \\
        -m repro_torch.launch.train ... --mesh D

``make_session`` checks D against ``WORLD_SIZE`` and joins the group (gloo
on the CPU, NCCL on CUDA); without ``--mesh`` D is ``WORLD_SIZE`` (1 when
unset).  A model axis above 1, or a pod axis (``PxDxM``), is not ported
yet and raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

from repro_torch.core.transparent import MESH_TODO


def parse_mesh(spec: str) -> Tuple[int, ...]:
    """``"D"`` / ``"DxM"`` / ``"PxDxM"`` -> the extents; a 1-D spec gets a
    model axis of 1 (pure data parallelism, the paper's setting)."""
    try:
        shape = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r} is not of the form 'D', 'DxM' or 'PxDxM' "
            "(e.g. '2x2' = 2-way data x 2-way model)") from None
    if len(shape) == 1:
        shape = shape + (1,)
    if len(shape) > 3 or any(s < 1 for s in shape):
        raise ValueError(
            f"mesh shape {shape} must be 1-3 positive extents "
            "(data | data x model | pod x data x model)")
    return shape


def add_session_flags(ap: argparse.ArgumentParser, *,
                      arch_default: str = "qwen2.5-14b"):
    """The flags every Session-backed launcher shares."""
    ap.add_argument("--arch", default=arch_default)
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-sized config variant")
    ap.add_argument("--mesh", default=None, type=_mesh_arg,
                    help="'D' or 'Dx1': D data-parallel processes of one "
                    "process group (start them with torch.distributed.run "
                    "--nproc-per-node D); a model or pod axis is not "
                    "ported yet (default: WORLD_SIZE, 1 when unset)")
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


def data_parallel_degree(mesh: Optional[Tuple[int, ...]]) -> int:
    """D of a parsed ``--mesh`` (``WORLD_SIZE`` without one); a model or
    pod axis raises."""
    if mesh is None:
        return int(os.environ.get("WORLD_SIZE", "1"))
    if len(mesh) == 3 or mesh[1] > 1:
        raise NotImplementedError(
            f"--mesh {'x'.join(map(str, mesh))}: a model or pod axis is not "
            f"ported yet — {MESH_TODO}")
    return mesh[0]


def init_process_group(args) -> int:
    """Join the process group of a D-process run (D > 1) started by
    ``torch.distributed.run``; returns D."""
    import torch
    import torch.distributed as dist
    d = data_parallel_degree(args.mesh)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if d != world:
        raise ValueError(
            f"--mesh asks for {d} processes but WORLD_SIZE is {world}: start "
            f"them with python -m torch.distributed.run --standalone "
            f"--nproc-per-node {d} -m <launcher> ...")
    if d > 1 and not dist.is_initialized():
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                                init_method="env://", world_size=d,
                                rank=int(os.environ["RANK"]))
    return d


def make_session(args, **load_kw):
    """Join the run's process group, then build the Session the launcher
    runs against."""
    init_process_group(args)
    from repro_torch import api
    return api.load(args.arch, smoke=args.smoke, seed=args.seed,
                    device=args.device, **load_kw)
