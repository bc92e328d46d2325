"""End-to-end training example: a ~100M-param LM through the full stack
(sharded data pipeline, transparent DP, checkpointing, straggler monitor)
on a 4x2 mesh of 8 processes — all through ``repro_torch.api``.

Run on 8 cards (NCCL):
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.examples.train_lm [--steps 200]
On one card:
  PYTHONPATH=src python -m repro_torch.examples.train_lm --mesh 1
On the CPU (8 gloo processes): the first command with ``--device cpu``.

Checkpoints go to a directory under the temporary directory
(``--ckpt-dir`` to choose).
"""
import argparse
import os
import tempfile

from repro_torch import api
from repro_torch.examples import add_device_flag, join_group, leave_group


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--mesh", default="4x2",
                    help="'DxM' (D·M processes) or 1 for one device")
    add_device_flag(ap, smoke=False)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m"))
    args = ap.parse_args(argv)
    rank = join_group(args.device)
    session = api.load("examples-lm-100m",
                       mesh=None if args.mesh == "1" else args.mesh,
                       allreduce="bucketed", device=args.device)
    result = session.train(steps=args.steps, seq_len=128, global_batch=16,
                           ckpt_dir=args.ckpt_dir, ckpt_every=50,
                           log_every=10)
    s = result.straggler
    if rank == 0:
        print(f"done: {result.step} steps, loss {result.loss:.4f}, "
              f"p50 {s.get('p50_s', 0.0)*1e3:.1f} ms/step, "
              f"total {result.elapsed_s:.1f}s")
    leave_group()
    return result


if __name__ == "__main__":
    main()
