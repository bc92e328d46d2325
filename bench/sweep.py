"""Find a cell's knee once: drive it at several arrival rates in one
process and print, for each, what says whether its queue grew.

    python3 bench/sweep.py --workload qwen14b-chat --rates 1,1.5,2 \
        --seconds 20 --seed 7

Each rate runs the cell's own traffic with ``arrivals.rate_per_s`` set to
it (pre-roll, then the window, a drain of at most 10 s) on an engine
built and warmed anew for it.  Printed per rate:
the window's end-to-end numbers, the median first-token wait of the
requests due in the window's first and last quarters, and the engine's
mean queue depth over its first and last quarter of cycles.  Not run by
the benchmark's own runs.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.core import spec as spec_mod
    from bench.core.cell import Cell, card, drive_window
    from bench.core.window import end_to_end, failures, percentile
    spec = spec_mod.cell(ROOT, args.workload)
    cell = Cell(spec["config"], spec["traffic"])
    cell.load(args.seed)
    print(json.dumps({"card": card()}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["arrivals"]["rate_per_s"] = rate
        eng = None
        cell.free()
        eng = cell.warm(args.seed)
        t = time.perf_counter()
        run, _ = drive_window(cell, args.seed, args.seconds, False,
                              drain_s=10.0)
        ws, we = run.window_start, run.window_end
        q = (we - ws) / 4
        early = [r.times[0] - r.due for r in run.measured
                 if r.times and r.due < ws + q]
        late = [r.times[0] - r.due for r in run.measured
                if r.times and r.due >= we - q]
        depth = eng.metrics.queue_depth
        n = max(len(depth) // 4, 1)
        out = {"rate_per_s": rate, **end_to_end(run),
               "attempted": len(run.measured), "failed": failures(run),
               "ttft_p50_first_quarter_ms":
                   1e3 * percentile(early, 50) if early else None,
               "ttft_p50_last_quarter_ms":
                   1e3 * percentile(late, 50) if late else None,
               "queue_first_quarter": sum(depth[:n]) / n,
               "queue_last_quarter": sum(depth[-n:]) / n,
               "wall_s": time.perf_counter() - t}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
