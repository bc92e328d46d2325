"""Readings for a cell's check limits, on the chip at the cell's own
size: for each seed, the program's readings and its control's, each
judged by the cell's own check (``check.judge``).

    python3 bench/calibrate.py --workload qwen14b-chat --seeds 11,12,13 \
        --seconds 15

One process, one program load: per seed, weights from the seed, a warm
engine, the cell's own traffic for ``--seconds`` (pre-roll first), then
the check's sample compared with the float32 reference (the program's
reading) and with the reference in fp8 put in the program's place (the
control's reading: the gap of the token fp8 puts first).  Each seed
prints one line with ``program`` and ``control``: ``correct`` as
``check.judge`` decides it under the configuration's ``check``, and each
number beside its limit.  Not run by the benchmark's own runs;
``bench/tests/test_bench_faults.py`` runs it as a ``cuda`` test.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--fp32-witness", action="store_true",
                    help="serve the program in float32 instead (weights "
                    "and compute) on a few of the traffic's requests, "
                    "8 slots: the program's arithmetic against the "
                    "reference's without bf16 rounding")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.core import spec as spec_mod
    from bench.core.cell import card
    spec = spec_mod.cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.fp32_witness:
        return fp32_witness(spec, seeds)
    print(json.dumps({"card": card(), "limits": spec["config"]["check"]}),
          flush=True)
    for out in readings(spec, seeds, args.seconds):
        print(json.dumps(out), flush=True)
    return 0


def readings(spec, seeds, seconds):
    """Per seed: ``{"seed", "compare_s", "program": ..., "control": ...}``,
    each side with ``correct`` (``check.judge`` under the configuration's
    ``check``) and each number compared beside its limit."""
    from bench.core import check
    from bench.core.cell import Cell, drive_window
    cell = Cell(spec["config"], spec["traffic"])
    limits = spec["config"]["check"]
    for seed in seeds:
        cell.load(seed)
        cell.warm(seed)
        run, _ = drive_window(cell, seed, seconds, False)
        cell.free()
        done = [r for r in run.measured if r.done_t is not None]
        reqs = check.sample(done, seed, check.MIN_SERVED_TOKENS,
                            spec["traffic"]["check"]["max_requests"])
        t = time.perf_counter()
        got = check.compare(cell.ref, cell.config, cell.weights, reqs,
                            control=True)
        out = {"seed": seed, "compare_s": time.perf_counter() - t}
        for side, nums in (("program", got),
                           ("control", check.control_readings(got))):
            out[side] = {"correct": check.judge(nums, limits),
                         **{k: {"value": nums[k], "limit": v}
                            for k, v in limits.items()},
                         **{k: nums[k] for k in ("logit_gap", "mean_gap",
                                                 "mismatch_share", "tokens")
                            if k not in limits}}
        yield out


def fp32_witness(spec, seeds) -> int:
    """The program in float32 (weights and compute, 8 slots) on the first
    requests of the cell's traffic, greedy, against the reference."""
    import torch
    from bench.core import check
    from bench.core.cell import Cell
    from bench.core.traffic import SessionTraffic
    from bench.core.weights import make_weights
    cfg = dict(spec["config"], dtype="float32")
    tr = dict(spec["traffic"], serve=dict(spec["traffic"]["serve"],
                                          max_batch=8))
    cell = Cell(cfg, tr)
    cell.session = type(cell.session)(
        cell.session.model.replace(compute_dtype="float32"),
        device="cuda")
    for seed in seeds:
        cell.weights = None
        cell.session.set_params(None)
        cell.weights = make_weights(cell.shapes, cell.ref.leaf_std, seed,
                                    "cuda", torch.float32)
        cell.session.set_params(cell.weights)
        traffic = SessionTraffic(tr, seed, cfg["vocab_size"],
                                 cell.serve_cfg.max_seq_len, 0.0, 1.0)
        reqs = traffic.pop_due(1.0)[:2]
        outs = cell.session.serve([r.prompt.tolist() for r in reqs],
                                  serve_cfg=cell.serve_cfg,
                                  max_new=min(r.max_new for r in reqs))
        for r, o in zip(reqs, outs):
            r.tokens = list(o)
        cell.free()
        got = check.compare(cell.ref, cfg, cell.weights, reqs)
        print(json.dumps({"seed": seed, "fp32_program": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
