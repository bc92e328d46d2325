"""Fault tolerance demo: train on 4 DP replicas (a 4x2 mesh of 8
processes), lose half of them mid-run (a simulated fault), resume on 2
replicas (2x2, 4 processes) from the last checkpoint — the ULFM-style
"continued execution" the paper targets (§II-B), enabled by the DP
replication argument of §III-B.

Run (8 gloo processes on the CPU; after the fault at step 17, processes 4-7
leave and 0-3 form a new group of 4):
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.examples.elastic_restart

Checkpoints go to a directory under the temporary directory, named by the
run's rendezvous port (``--ckpt-dir`` to choose).  The smoke config's
head_dim is 16, which the CUDA kernels do not take, so the trainers run
on ``--device cpu`` (its default) and ``cuda`` is refused.
"""
import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.failures import FaultInjector, run_with_recovery
from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.core.transparent import TransparentTrainer
from repro_torch.examples import add_device_flag, join_group, refuse_cuda
from repro_torch.models import registry

WORLD, SHRUNK = 8, 4


def _shrink(ckpt):
    """The fault: processes SHRUNK.. leave; the rest form a new group of
    SHRUNK processes (a file rendezvous in the checkpoint directory)."""
    rank = dist.get_rank()
    dist.barrier()
    dist.destroy_process_group()
    if rank >= SHRUNK:
        print(f"[rank {rank}] replica lost: leaving", flush=True)
        sys.exit(0)
    dist.init_process_group("gloo", init_method=f"file://{ckpt}/pg_shrunk",
                            world_size=SHRUNK, rank=rank)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(),
        f"repro_torch_elastic_{os.environ.get('MASTER_PORT', 'local')}"))
    add_device_flag(ap, smoke=True)
    args = ap.parse_args(argv)
    refuse_cuda("elastic_restart", args.device)
    ckpt = args.ckpt_dir
    rank = join_group(args.device)
    if not dist.is_initialized() or dist.get_world_size() != WORLD:
        raise SystemExit(f"start {WORLD} processes: python -m "
                         "torch.distributed.run --standalone "
                         f"--nproc-per-node {WORLD} -m "
                         "repro_torch.examples.elastic_restart")
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
        os.makedirs(ckpt)
    dist.barrier()
    say = print if rank == 0 else (lambda *a, **k: None)

    cfg = get_config("stablelm-1.6b", smoke=True)
    bundle = registry.build(cfg)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (8, 16)), dtype=torch.int32),
                "labels": torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (8, 16)), dtype=torch.int32)}
               for _ in range(40)]
    current = {}

    def make_trainer(attempt):
        # first attempt: 4 DP replicas; after the fault: shrink to 2
        dp = 4 if attempt == 0 else 2
        if attempt and dist.get_world_size() != 2 * dp:
            _shrink(ckpt)
        say(f"[supervisor] building mesh with data={dp} (attempt {attempt})")
        run = RunConfig(
            model=cfg, shape=ShapeConfig("e", "train", 16, 8),
            mesh=MeshConfig(shape=(dp, 2), axis_names=("data", "model"),
                            allreduce="layerwise"),
            optimizer=OptimizerConfig(name="adam", lr=1e-2))
        tr = TransparentTrainer(run, bundle.loss_fn, bundle.specs,
                                device=args.device)
        current.update(trainer=tr, dp=dp)
        return tr

    def local_batches(start):
        # this replica's rows of each global batch (its model ranks alike)
        n = 8 // current["dp"]
        r = current["trainer"].rank
        return ({k: v[r * n:(r + 1) * n] for k, v in b.items()}
                for b in batches[start:])

    state, hist = run_with_recovery(
        make_trainer=make_trainer, data_iter_factory=local_batches,
        ckpt_dir=ckpt, total_steps=30, ckpt_every=10,
        injector=FaultInjector(fail_at_steps=(17,)))

    say(f"\nrestarts: {hist['restarts']}  "
        f"resumed at steps: {hist['resume_steps']}")
    say("loss curve (around the fault at step 17):")
    for s, l in hist["losses"]:
        mark = "  <- resumed here" if s in (11,) else ""
        say(f"  step {s:3d}  loss {l:.4f}{mark}")
    say("training survived the replica loss and finished on the "
        "shrunk mesh.")
    dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
