"""Serving example: the continuous-batching engine through
``repro_torch.api`` (admission queue -> paged KV -> batched decode ->
streamed greedy generation; see ``src/repro_torch/serving/``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm

The smoke config's head_dim is 16, which the CUDA kernels do not take, so
the script runs on ``--device cpu`` (its default) and refuses ``cuda``;
on a card, load a full config (there is no fallback from one to the
other).
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.examples import add_device_flag, refuse_cuda


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_flag(ap, smoke=True)
    args = ap.parse_args(argv)
    refuse_cuda("serve_lm", args.device)
    session = api.load("qwen2.5-14b", smoke=True, require=("serve",),
                       device=args.device)
    rng = np.random.default_rng(0)
    vocab = session.model.vocab_size
    prompts = [[int(t) for t in rng.integers(0, vocab, (int(n),))]
               for n in rng.integers(6, 13, size=6)]

    outs = session.serve(
        prompts, max_new=8, max_batch=3,
        stream=lambda rid, tok, done: print(
            f"  req {rid} -> {tok}{'  [done]' if done else ''}", flush=True))
    s = session.engine.metrics.summary()
    print(f"served {s['completed']}/{len(prompts)} requests, "
          f"{s['tokens_out']} tokens ({s['tokens_per_sec']:.1f} tok/s)")
    for i, toks in enumerate(outs):
        print(f"  req {i}: {toks}")
    return prompts, outs


if __name__ == "__main__":
    main()
