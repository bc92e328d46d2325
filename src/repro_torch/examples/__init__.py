"""The reference's examples on the port, run with ``python -m``:
``quickstart``, ``train_lm``, ``serve_lm``, ``elastic_restart``.  The
multi-device ones start under ``torch.distributed.run`` (one process per
mesh device: gloo on the CPU, NCCL on cards); nothing runs at import.

Each takes ``--device {cuda,cpu}``.  ``train_lm``'s model (head_dim 64)
runs on cards by default; the other three keep the reference's smoke
configs, whose head_dim 16 the CUDA kernels do not take, so they default
to ``cpu`` and refuse ``cuda`` (there is no fallback from one to the
other)."""
import os

#: why the smoke-config examples refuse ``--device cuda``
SMOKE_ON_CUDA = ("its smoke config has head_dim 16, which the CUDA kernels "
                 "do not take; run it with --device cpu")


def add_device_flag(ap, *, smoke: bool) -> None:
    """``--device {cuda,cpu}``: ``cuda`` by default, ``cpu`` for the
    examples built on a smoke config (which refuse ``cuda``)."""
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default="cpu" if smoke else "cuda",
                    help="where the model runs" + (
                        " (cpu only: the smoke config's head_dim 16 is not "
                        "a kernel shape)" if smoke else ""))


def refuse_cuda(name: str, device: str) -> None:
    """A smoke-config example asked for the card: stop with the reason."""
    if device == "cuda":
        raise SystemExit(f"{name}: {SMOKE_ON_CUDA}")


def join_group(device: str) -> int:
    """Join the process group ``torch.distributed.run`` started (its
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_*``
    environment), if any: NCCL on ``cuda`` (this process on card
    ``LOCAL_RANK``), gloo on ``cpu``.  Returns this process's rank (0
    alone).  The examples' only distribution code, kept outside the user
    scripts as a launcher keeps it."""
    import torch
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method="env://", world_size=world,
                                rank=int(os.environ["RANK"]))
    return dist.get_rank() if dist.is_initialized() else 0


def leave_group() -> None:
    """Tear down the process group ``join_group`` joined (its threads must
    not outlive the interpreter)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
