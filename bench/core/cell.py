"""One run of one cell: set-up, the window, the trace, the check, the
result line.

Set-up loads the program (``repro_torch.api.load``), makes the weights
from the seed on the device and hands them over (``Session.set_params``;
their shapes are checked against the program's parameter specs first),
and warms the engine on the cell's own shapes: one ``Session.serve`` of
prompts whose prefill chunks cover every bucket the traffic can give
(a prefix hit, then suffixes of 16 .. ``prefill_chunk_tokens``), which
also builds the kernels and captures the decode graph at the cell's slot
count.  The prefix cache is then emptied and the engine's counters reset.
"""
from __future__ import annotations

import gc
import importlib
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from bench.core import check as check_mod
from bench.core import spec as spec_mod
from bench.core import trace as trace_mod
from bench.core import work
from bench.core.traffic import SessionTraffic
from bench.core.weights import make_weights, shape_mismatches
from bench.core.window import drive, end_to_end, failures, spread_of_waits

#: top-level module names that may not be loaded when the result prints
BANNED = ("jax", "jaxlib", "flax", "repro")

#: the traced run's profiled slice, seconds (at most half the window)
TRACE_SLICE_S = 3.0
#: after the window, how long the harness waits for the measured requests
DRAIN_S = 60.0

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``BANNED``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in BANNED)


class Cell:
    """A cell's program under test: session, weights and warm engine."""

    def __init__(self, config: Dict, traffic: Dict, *, device: str = "cuda",
                 smoke: bool = False):
        from repro_torch import api
        from repro_torch.configs.base import ServeConfig
        self.config, self.traffic, self.device = config, traffic, device
        self.ref = importlib.import_module(
            f"bench.reference.{config['reference']}")
        self.serve_cfg = ServeConfig(**traffic["serve"])
        self.session = api.load(config["arch"], smoke=smoke, device=device)
        self.shapes = self.ref.param_shapes(config)
        bad = shape_mismatches(self.shapes, self.session.bundle.specs)
        if bad:
            raise SystemExit("the program's parameters differ from the "
                             f"configuration's: {bad[:8]}")
        self.weights = None
        self.engine = None

    def load(self, seed: int) -> None:
        """Weights from ``seed`` (the previous ones freed first)."""
        self.engine = None
        self.weights = None
        self.session.set_params(None)
        gc.collect()
        self.weights = make_weights(self.shapes, self.ref.leaf_std, seed,
                                    self.device,
                                    DTYPES[self.config["dtype"]])
        self.session.set_params(self.weights)

    def warm(self, seed: int):
        """Serve the warm-up prompts; returns the warm engine."""
        cfg = self.serve_cfg
        rng = np.random.default_rng([seed, 6])
        V = self.config["vocab_size"]
        chunk = cfg.prefill_chunk_tokens or 512
        head = rng.integers(0, V, chunk).tolist()
        prompts = [head + rng.integers(0, V, chunk + 100).tolist()]
        b = 16
        while b <= chunk:
            prompts.append(head + rng.integers(0, V, b).tolist())
            b *= 2
        self.session.serve(prompts, max_new=8, serve_cfg=cfg)
        self.engine = self.session.engine
        self.engine.pool.clear_prefix_cache()
        self.engine.metrics.reset()
        return self.engine

    def free(self) -> None:
        """Drop the engine (pool, graphs, prefix cache); keep the weights."""
        self.engine = None
        if self.weights is not None:
            self.session.set_params(self.weights)
        gc.collect()
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def counters_of(engine):
    m = engine.metrics
    return lambda: {"prefix_hit_tokens": m.prefix_hit_tokens,
                    "prefill_tokens": m.prefill_tokens}


def drive_window(cell: Cell, seed: int, seconds: float, trace: bool, *,
                 drain_s: float = DRAIN_S):
    """Pre-roll, window and drain; returns (run, slice hooks or None)."""
    tr = cell.traffic
    clock = time.perf_counter
    start = clock()
    ws = start + tr.get("preroll_s", 0.0)
    we = ws + seconds
    traffic = SessionTraffic(tr, seed, cell.config["vocab_size"],
                             cell.serve_cfg.max_seq_len, start, we)
    hooks = None
    if trace:
        # the slice ends a second before the window does: stopping the
        # profiler parses its trace on the host, which stalls the loop
        length = min(TRACE_SLICE_S, seconds / 2)
        t0 = max(we - length - 1.0, ws)
        hooks = trace_mod.SliceHooks(cell.engine, t0, length, clock)
    run = drive(cell.engine, traffic, window_start=ws, window_end=we,
                drain_s=drain_s, clock=clock, hooks=hooks,
                counters=counters_of(cell.engine))
    return run, hooks


def layer_context(cell: Cell, run, hooks) -> Optional[SimpleNamespace]:
    """What the per-layer readers read: the slice's kernels, launches,
    tokens and chunks, and the window's counters."""
    c0, c1 = run.counters.get("start", {}), run.counters.get("end", {})
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in c0}
    ctx = SimpleNamespace(config=cell.config, dims=work.dims(cell.config),
                          counters=delta, red=None)
    if hooks is None or hooks.first is None or hooks.last is None:
        return ctx
    red = trace_mod.reduce_profile(hooks.prof)
    t0 = red["t0"]
    t1 = t0 + hooks.wall * 1e6
    busy, gaps = trace_mod.busy_and_gaps(red, t0, t1)
    toks = trace_mod.slice_tokens(run, hooks.first, hooks.last)
    ctx.red, ctx.wall, ctx.busy, ctx.gaps = red, hooks.wall, busy, gaps
    ctx.groups = work.decode_groups(toks)
    ctx.first_tokens = sum(1 for t in toks for _, j in t if j == 0)
    ctx.chunks = trace_mod.slice_chunks(hooks)
    return ctx


def card() -> Dict:
    """The card's name and power limit, beside every number printed."""
    import subprocess
    out = {"name": torch.cuda.get_device_name(0)}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        out["power_limit"] = q.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "unknown"
    return out


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", smoke: bool = False,
             chips: int = 1) -> Dict:
    """One run; returns the result object (the last line's)."""
    on_card = device == "cuda"
    if on_card:
        info = card()
        torch.cuda.reset_peak_memory_stats()
    cell = Cell(spec["config"], spec["traffic"], device=device, smoke=smoke)
    cell.load(seed)
    cell.warm(seed)
    if trace:
        trace_mod.warm_profiler(on_card)
    run, hooks = drive_window(cell, seed, seconds, trace)
    setup_s = run.window_start - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics: Dict[str, Dict] = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": info["name"] if on_card else "cpu", "count": chips,
           "memory_peak_bytes": int(peak)}
    extra: Dict = {}
    if trace:
        ctx = layer_context(cell, run, hooks)
        for m in spec["per_layer"]:
            v = spec_mod.reader(spec["root"], m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ctx.red is not None:
            dev.update(busy_s=ctx.busy, window_s=ctx.wall)
            extra["breakdown"] = trace_mod.breakdown(ctx.red, ctx.gaps)
        del ctx
    else:
        e2e = end_to_end(run)
        e2e["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    hooks = None
    cell.free()
    finished = [r for r in run.measured if r.done_t is not None]
    reqs = check_mod.sample(finished, seed, check_mod.MIN_SERVED_TOKENS,
                            spec["traffic"]["check"]["max_requests"])
    limits = spec["config"]["check"]
    t_check = time.perf_counter()
    if reqs:
        got = check_mod.compare(cell.ref, cell.config, cell.weights, reqs)
    else:
        got = {"tokens": 0, "requests": 0}
    correct = check_mod.judge(got, limits)
    late = sorted(run.late_s)
    result = {
        "correct": bool(correct), "attempted": len(run.measured),
        "failed": failures(run), "metrics": metrics, "device": dev, **extra,
        "card": info if on_card else {"name": "cpu"},
        "sample": {"requests": got["requests"], "tokens": got["tokens"],
                   "check_s": time.perf_counter() - t_check,
                   "generator_late_p99_s": late[int(0.99 * (len(late) - 1))]
                   if late else 0.0, **spread_of_waits(run)},
        "check": {k: {"value": got.get(k), "limit": v}
                  for k, v in limits.items()},
    }
    return result
