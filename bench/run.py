"""Run one cell of the serving benchmark of ``repro_torch`` once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: puts the checkout and its ``src/`` on the
import path, loads the cell named in ``BENCHMARK.json``, sets up, measures
for ``--seconds`` (``--trace 0``: the end-to-end metrics; ``--trace 1``:
the per-layer metrics, from a profiled slice of the window), checks the
served tokens against the plain reference, and prints one JSON object as
its last line.  Without a CUDA card (or with fewer than the cell asks for)
it exits with code 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    from bench.core import spec as spec_mod
    spec = spec_mod.cell(ROOT, args.workload)
    chips = spec["workload"]["chips"]

    import torch
    import repro_torch.api  # noqa: F401  (the program under test)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from bench.core.cell import banned_modules, run_cell
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START, chips=chips)
    banned = banned_modules()
    if banned:
        print(f"bench: the run loaded JAX-side modules: {banned}",
              file=sys.stderr)
        return 4
    print(f"correct {result['correct']} on {result['card']}, sample "
          f"{result['sample']}", file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
