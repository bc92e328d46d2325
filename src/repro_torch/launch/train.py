"""Training CLI: a thin adapter over ``repro_torch.api`` (the one supported
entrypoint — the Session owns the trainer, data pipeline and checkpoints;
this file only turns flags into a ``Session.train`` call).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch stablelm-1.6b --smoke --steps 100 --device cpu \\
        --allreduce layerwise --ckpt-dir /tmp/ckpt

The user-visible script is sequential, per the paper's thesis: the mesh /
allreduce flags select the distribution, they never change the training
code path.  Over a mesh of D·M processes of one process group (D
data-parallel replicas, each tensor-parallel over M; ``--dp-mode fsdp``
shards the weights over the replicas too):

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --smoke --mesh 2x2

On the CPU use --smoke (reduced configs) and --device cpu; on an H100 the
same launcher runs the full configs.  encdec and vlm (whisper, pixtral)
fail as the reference's launcher does: the synthetic data carries tokens
only, and their loss needs frames / patches.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs.base import OptimizerConfig
from repro_torch.launch import cli


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    cli.add_session_flags(ap, arch_default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--dp-mode", default=None,
                    choices=["replicated", "fsdp"])
    ap.add_argument("--allreduce", default=None)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()

    session = cli.make_session(args, dp_mode=args.dp_mode,
                               allreduce=args.allreduce)
    try:
        result = session.train(
            steps=args.steps, seq_len=args.seq_len,
            global_batch=args.global_batch,
            optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr),
            microbatch=args.microbatch, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, resume=args.resume, log_every=10)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    s = result.straggler
    print(f"done: {result.step} steps, loss {result.loss:.4f}, "
          f"p50 {s.get('p50_s', 0.0)*1e3:.1f} ms/step, "
          f"total {result.elapsed_s:.1f}s")


if __name__ == "__main__":
    main()
