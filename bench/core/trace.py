"""The traced run's profiler slice and what is read from it.

``--trace 1`` profiles a steady slice in the middle of the window with
``torch.profiler`` (CPU and CUDA activity; CUPTI records the kernels that
graph replays launch).  The slice opens and closes at engine-step
boundaries, each behind ``torch.cuda.synchronize()``, so the device work
inside it is exactly what the host launched inside it: the engine steps
``first .. last`` of the slice.  A step retires the previous one's
tokens, so the tokens computed in the slice are those emitted in steps
``first + 1 .. last + 1``.  The harness wraps its own calls into each
layer in ``record_function`` ranges (``bench.traffic``, ``engine.submit``,
``engine.step``, ``bench.idle``), which name the host's activity behind
each idle gap of the device.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

#: host CUDA API calls that put work on the card: one kernel, or a graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
#: harness ranges (the outer layer of every idle gap's label)
RANGES = ("bench.traffic", "engine.submit", "engine.step", "bench.idle")


class SliceHooks:
    """``drive`` hooks: open the profiler at the first step boundary after
    ``t0``, close it ``length`` seconds later, and record which steps and
    which prefill chunks fell inside."""

    def __init__(self, engine, t0: float, length: float,
                 clock=time.perf_counter):
        self.t0, self.length, self.clock = t0, length, clock
        self.on_card = engine.device.type == "cuda"
        self.prof = None
        self.active = False
        self.first = self.last = None
        self.wall = 0.0
        self.chunks: List[Tuple[int, int, int]] = []   # (step, start, n)
        self._run = None
        bundle = engine.bundle
        inner = bundle.paged_prefill_fn

        def counted(params, toks, state, **kw):
            self.chunks.append((self._run.step if self._run else -1,
                                int(state["start"]), int(state["n_valid"])))
            return inner(params, toks, state, **kw)
        bundle.paged_prefill_fn = counted

    def span(self, name: str):
        if not self.active:
            return _null()
        return torch.profiler.record_function(name)

    def tick(self, run) -> None:
        """At a step boundary: open the slice once ``t0`` has passed, close
        it ``length`` seconds after it opened."""
        self._run = run
        now = self.clock()
        if self.first is None and now >= self.t0:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.on_card:
                torch.cuda.synchronize()
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.active = True
            self._w0 = self.clock()
            self.first = run.step
        elif self.active and now >= self._w0 + self.length:
            self.close(run)

    def close(self, run) -> None:
        if self.active:
            if self.on_card:
                torch.cuda.synchronize()
            self.wall = self.clock() - self._w0
            self.prof.__exit__(None, None, None)
            self.active = False
            self.last = run.step - 1


@contextmanager
def _null():
    yield


def warm_profiler(on_card: bool) -> None:
    """Start and stop the profiler once during set-up: its first start
    initialises CUPTI (seconds), which must not fall inside the window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts):
        x = torch.ones(8, device="cuda" if on_card else "cpu")
        (x + x).sum().item()


def _on_device(e) -> bool:
    """A kernel, copy or fill on the card (not a range the host opened,
    which the trace mirrors on the device's timeline)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in RANGES)


def reduce_profile(prof) -> Dict:
    """Kernel intervals, host launch calls and host events of a profile:
    ``{"kernels": [(name, start_us, end_us)], "launches": n, "host":
    [(name, start_us, end_us)], "t0": the first host event (us)}``; the
    slice is ``t0 .. t0 + wall``."""
    kernels, host = [], []
    launches = 0
    for e in prof.events():
        tr = e.time_range
        if _on_device(e):
            kernels.append((e.name, tr.start, tr.end))
        elif e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name in LAUNCH_CALLS:
                launches += 1
            host.append((e.name, tr.start, tr.end))
    t0 = min((s for _, s, _ in host), default=0.0)
    return {"kernels": kernels, "launches": launches, "host": host,
            "t0": t0}


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_and_gaps(red: Dict, t0: float, t1: float):
    """(busy seconds, [(gap start, gap end)] in us) of the device within
    [t0, t1] (us): the union of its kernel and copy intervals."""
    iv = union([(max(s, t0), min(e, t1)) for _, s, e in red["kernels"]
                if e > t0 and s < t1])
    busy = sum(e - s for s, e in iv) / 1e6
    gaps, cur = [], t0
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


def label_gap(red: Dict, mid: float) -> str:
    """What the host was doing at ``mid`` (us): the harness range around
    it and the innermost host event inside that range."""
    outer, inner, inner_len = "other", None, float("inf")
    for name, s, e in red["host"]:
        if s <= mid <= e:
            if name in RANGES:
                outer = name
            elif e - s < inner_len:
                inner, inner_len = name, e - s
    return outer if inner is None else f"{outer}/{inner}"


def breakdown(red: Dict, gaps) -> Dict:
    """The ten kernels that took most device time, and the ten longest
    idle gaps named by the host's activity."""
    by_name = defaultdict(float)
    for name, s, e in red["kernels"]:
        by_name[name] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[label_gap(red, (s + e) / 2), (e - s) / 1e6]
                          for s, e in longest]}


def kernel_seconds(red: Dict, marks: Tuple[str, ...],
                   skip: Tuple[str, ...] = ()) -> float:
    """Device seconds of the kernels whose names hold one of ``marks``
    (and none of ``skip``)."""
    return sum(e - s for n, s, e in red["kernels"]
               if any(m in n for m in marks)
               and not any(k in n for k in skip)) / 1e6


def slice_tokens(run, first: int, last: int):
    """Tokens computed in steps ``first..last``: those emitted (retired)
    in steps ``first + 1 .. last + 1``."""
    return [run.step_tokens.get(k, []) for k in range(first + 1, last + 2)]


def slice_chunks(hooks: SliceHooks) -> List[Tuple[int, int]]:
    return [(s, n) for k, s, n in hooks.chunks
            if hooks.first <= k <= hooks.last]

