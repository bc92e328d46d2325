"""The card's idle time inside the program's ranges (``core/phases.py``
and the three readers on it): exact milliseconds on a synthetic slice, the
three metrics in a traced smoke run on the CPU, and, on a card (``cuda``
marker), that no range of the program counts as device work:

    python3 -m pytest -m cuda -s bench/tests/test_bench_phases.py
"""
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import smoke
from bench.core import phases
from bench.core import spec as spec_mod
from bench.core import trace as trace_mod
from bench.core.cell import Cell, drive_window, layer_context, run_cell

ROOT = Path(__file__).resolve().parents[2]
NEW = ("prefill_idle_ms.chat", "prefill_idle_ms.batch", "moe_sorted_idle_ms")
#: every range the program enters while a profile is active
PROGRAM_RANGES = {"step", "step.plan", "preempt", "admit", "plan",
                  "step.draft", "step.submit", "prefill.chunk",
                  "prefill.device", "decode.device", "verify.device",
                  "step.retire", "moe.sorted"}


def _ctx(host, kernels, t1=120_000.0):
    red = {"kernels": kernels, "launches": 0, "host": host, "t0": 0.0}
    busy, gaps = trace_mod.busy_and_gaps(red, 0.0, t1)
    return SimpleNamespace(red=red, gaps=gaps, busy=busy, wall=t1 / 1e6)


def _read(name, ctx):
    return spec_mod.reader(ROOT, name)(ctx)


def test_idle_inside_ranges_in_exact_milliseconds():
    # device busy 0-10, 30-40, 60-100 ms of a 120 ms slice (times in us):
    # idle 10-30, 40-60, 100-120
    kernels = [("k", 0.0, 10_000.0), ("k", 30_000.0, 40_000.0),
               ("k", 60_000.0, 100_000.0)]
    host = [("engine.step", 0.0, 120_000.0),
            ("prefill.chunk", 5_000.0, 45_000.0),
            ("prefill.chunk", 95_000.0, 120_000.0),
            ("moe.sorted", 12_000.0, 25_000.0),
            ("moe.sorted", 50_000.0, 58_000.0),    # outside any chunk
            ("moe.sorted", 100_000.0, 110_000.0),
            ("decode.device", 58_000.0, 70_000.0),
            ("cudaGraphLaunch", 59_000.0, 61_000.0)]
    ctx = _ctx(host, kernels)
    # chunks: 20 (10-30) + 5 (40-45) + 20 (100-120) ms over 2 chunks
    assert _read("prefill_idle_ms.chat", ctx) == pytest.approx(22.5)
    assert _read("prefill_idle_ms.batch", ctx) == pytest.approx(22.5)
    # sorted route: 13 + 8 + 10 ms over the 2 chunks
    assert _read("moe_sorted_idle_ms", ctx) == pytest.approx(15.5)
    # one decode cycle, idle 58-60 ms, read by the helper
    assert phases.idle_ms(ctx, "decode.device") == pytest.approx(2.0)


def test_overlapping_ranges_count_their_idle_once():
    kernels = [("k", 50_000.0, 120_000.0)]                # idle 0-50 ms
    host = [("prefill.chunk", 0.0, 30_000.0),
            ("prefill.chunk", 20_000.0, 40_000.0)]
    ctx = _ctx(host, kernels)
    assert phases.prefill_idle_ms(ctx) == pytest.approx(40.0 / 2)
    assert phases.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10


def test_none_where_the_slice_has_no_such_range():
    kernels = [("k", 0.0, 60_000.0)]
    ctx = _ctx([("engine.step", 0.0, 120_000.0),
                ("moe.sorted", 70_000.0, 80_000.0)], kernels)
    # a program that enters no range (the parent), or a slice without
    # chunks, reads nothing
    for name in NEW:
        assert _read(name, ctx) is None
    assert _read("moe_sorted_idle_ms", SimpleNamespace(red=None)) is None
    ctx = _ctx([("prefill.chunk", 0.0, 90_000.0)], kernels)
    assert _read("moe_sorted_idle_ms", ctx) is None       # no MoE layer
    assert _read("prefill_idle_ms.batch", ctx) == pytest.approx(30.0)


def test_traced_run_reports_the_three_metrics():
    """A traced smoke run of the MoE family: chunks on the sorted route
    and decode cycles in the slice (on the CPU no kernel runs, so each
    range is idle card throughout: a count, not a device time)."""
    per_layer = [{"name": n, "unit": "ms", "workloads": ["smoke"]}
                 for n in NEW]
    spec = smoke.spec(smoke.config("deepseek-v2-lite-16b"), smoke.batch(),
                      [{"name": "serve_tok_s", "unit": "u"}], per_layer)
    r = run_cell(spec, 2**31 + 23, 3.0, True, t_start=time.perf_counter(),
                 device="cpu", smoke=True)
    got = r["metrics"]
    assert set(NEW) <= set(got)
    assert all(got[n]["value"] > 0 for n in NEW)
    assert got["moe_sorted_idle_ms"]["value"] < \
        got["prefill_idle_ms.batch"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["qwen14b-chat", "dsv2lite-batch"])
def test_no_program_range_is_device_work_on_the_card(workload):
    """A traced slice of the cell on the card (pre-roll cut to 5 s, an 8 s
    window): the program's ranges are host events of the profile, and
    none of them is among its kernels and copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's full-size model "
                    "(run on the card with `pytest -m cuda`)")
    spec = spec_mod.cell(ROOT, workload)
    seed = 2**31 + 301
    cell = Cell(spec["config"], dict(spec["traffic"], preroll_s=5.0))
    try:
        cell.load(seed)
        cell.warm(seed)
        trace_mod.warm_profiler(True)
        run, hooks = drive_window(cell, seed, 8.0, True, drain_s=0.0)
        red = trace_mod.reduce_profile(hooks.prof)
        ctx = layer_context(cell, run, hooks)
        readings = {n: spec_mod.reader(ROOT, n)(ctx) for n in NEW}
    finally:
        cell.engine = cell.weights = None      # both cells' models in turn
        cell.session.set_params(None)
        cell.free()
    kernels = {n for n, _, _ in red["kernels"]}
    host = {n for n, _, _ in red["host"]}
    print(workload, json.dumps({"ranges": sorted(PROGRAM_RANGES & host),
                                "readings": readings,
                                "idle_share": 100 * (1 - ctx.busy / ctx.wall)}),
          flush=True)
    assert {"step", "step.plan", "decode.device", "step.retire"} <= host
    assert not PROGRAM_RANGES & kernels
