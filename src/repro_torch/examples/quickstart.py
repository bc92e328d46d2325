"""Quickstart: the paper's Fig. 3 experience, one Session for everything.

The "user script" below is purely sequential — pick a model, train it, ask
it for tokens.  ``repro_torch.api`` is the runtime: it injects broadcast
init, gradient all-reduce, sharded data ingestion (training) and
continuous batching + KV-cache management (generation).  The
``mesh="4x2"`` string is the *entire* distribution configuration: one
process per mesh device runs this same script; ``--mesh 1`` runs the
identical script on one device.

Run (8 gloo processes on the CPU):
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.examples.quickstart
One device:
  PYTHONPATH=src python -m repro_torch.examples.quickstart --mesh 1

The smoke config's head_dim is 16, which the CUDA kernels do not take, so
the script runs on ``--device cpu`` (its default) and refuses ``cuda``;
on a card, load a full config (there is no fallback from one to the
other).
"""
import argparse

from repro_torch import api
from repro_torch.examples import (add_device_flag, join_group,
                                  leave_group, refuse_cuda)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="4x2",
                    help="'DxM' (D·M processes) or 1 for one device")
    add_device_flag(ap, smoke=True)
    args = ap.parse_args(argv)
    refuse_cuda("quickstart", args.device)
    rank = join_group(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = None if args.mesh == "1" else args.mesh

    # ----- user code (sequential, no distribution constructs) --------------
    session = api.load("stablelm-1.6b", smoke=True, mesh=mesh,
                       device=args.device)
    say(session)

    result = session.train(steps=30, seq_len=32, global_batch=16,
                           log_every=5)
    say(f"trained {result.step} steps: loss {result.losses[0]:.4f} -> "
        f"{result.loss:.4f}")

    # one-shot generation from the trained weights, same Session
    tokens = session.generate([3, 1, 4, 1, 5, 9, 2, 6], max_new=12)
    say(f"generated: {tokens}")

    # a closed batch through the continuous-batching engine
    outs = session.serve([[1, 2, 3], [4, 5, 6, 7], [8, 9]], max_new=6)
    for i, toks in enumerate(outs):
        say(f"  req {i}: {toks}")
    say("done — trained data-parallel and served continuous-batch; "
        "the script stayed serial.")
    say(f"losses: {[float(x) for x in result.losses]!r}")
    leave_group()
    return {"losses": list(result.losses), "tokens": tokens, "outs": outs}


if __name__ == "__main__":
    main()
