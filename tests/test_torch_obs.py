"""Engine tracing of the PyTorch port (``repro_torch.obs``).

  * the tracer under a fake device clock: each device span's pair of
    stream events lands on the tracer's host clock through the anchor,
    resolves without waiting once complete (in stream order), and forms a
    ``device`` track of the Chrome trace; export resolves the rest with
    one synchronize;
  * the disabled path: ``NULL_TRACER`` records nothing and hands out one
    shared span, which becomes a ``record_function`` range only while a
    profile is active;
  * ranges in a profile: an untraced engine's phases (and the MoE layer's
    sorted route) under ``torch.profiler`` on the CPU;
  * a traced engine: no fences, device pairs resolved after retire,
    lifecycle spans balanced through chunked prefill and preemption;
  * ``ServingMetrics``' bounded per-cycle samples.
"""
import inspect
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ServeConfig, get_config
from repro_torch.obs import (DEVICE_TRACK, ENGINE_TRACK, NULL_TRACER,
                             Tracer, chrome_trace, phase_snapshot,
                             profile_range, request_track)
from repro_torch.serving import ServingEngine, ServingMetrics
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.metrics import QUEUE_HISTORY


class FakeClock:
    """Deterministic monotone host clock: every read advances by ``tick``."""

    def __init__(self, tick=1.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


class FakeDeviceClock:
    """A device timeline the test drives: ``record`` stamps the device's
    time ``t`` (seconds); an event completes when the test completes it,
    at ``synchronize``, or at once with ``auto``."""

    def __init__(self, auto=False):
        self.t = 100.0
        self.auto = auto
        self.events = []
        self.syncs = 0
        self.anchors = 0

    def anchor(self, clock):
        self.anchors += 1
        self._dev0, self._host0 = self.t, clock()

    def record(self):
        ev = {"t": self.t if not self.auto else time.perf_counter(),
              "done": self.auto}
        self.events.append(ev)
        return ev

    def done(self, ev):
        return ev["done"]

    def seconds(self, ev):
        return self._host0 + (ev["t"] - self._dev0)

    def complete(self, n=None):
        for ev in self.events[:n]:
            ev["done"] = True

    def synchronize(self):
        self.syncs += 1
        self.complete()


def _prompts(rng, vocab, lengths):
    return [[int(t) for t in rng.integers(0, vocab, (n,))] for n in lengths]


def _range_names(prof):
    return {e.name for e in prof.events()}


# ---------------------------------------------------------------------------
# Tracer mechanics under a fake device clock
# ---------------------------------------------------------------------------

def test_device_pairs_land_on_the_host_clock_by_the_anchor():
    clk, dev = FakeClock(), FakeDeviceClock()
    tr = Tracer(clock=clk, device_clock=dev)   # anchor: device 100 <-> host 1
    assert dev.anchors == 1 and tr.t0 == 2.0
    dev.t = 100.5
    with tr.device_span("decode.device", rows=3):   # host 3 .. 4
        dev.t = 100.75
    # the host span is there at once, on the engine track
    assert tr.phase_seconds == {"decode.device": 1.0}
    assert tr.device_seconds == {} and tr.resolve() == 0   # still running
    dev.complete()
    assert tr.resolve() == 1 and dev.syncs == 0
    ph, name, track, ts, dur, args = tr.events[-1]
    assert (ph, name, track, args) == ("X", "decode.device", DEVICE_TRACK,
                                       {"rows": 3})
    assert ts == pytest.approx(1.5) and dur == pytest.approx(0.25)
    assert tr.device_seconds == {"decode.device": pytest.approx(0.25)}


def test_resolve_keeps_stream_order_and_never_waits():
    dev = FakeDeviceClock()
    tr = Tracer(clock=FakeClock(), device_clock=dev)
    for name in ("prefill.device", "decode.device", "verify.device"):
        with tr.device_span(name):
            dev.t += 0.1
    dev.complete(2)            # the first pair's two events only
    assert tr.resolve() == 1
    assert [e[1] for e in tr.events if e[2] == DEVICE_TRACK] == \
        ["prefill.device"]
    assert dev.syncs == 0 and len(tr._pending) == 2
    # export: the rest resolve after one synchronize
    doc = chrome_trace(tr)
    assert dev.syncs == 1 and not tr._pending
    dev_tid = next(e["tid"] for e in doc["traceEvents"]
                   if e["ph"] == "M" and e["name"] == "thread_name"
                   and e["args"]["name"] == DEVICE_TRACK)
    assert dev_tid == 1
    spans = [e["name"] for e in doc["traceEvents"]
             if e["ph"] == "X" and e["tid"] == dev_tid]
    assert spans == ["prefill.device", "decode.device", "verify.device"]


def test_reset_reanchors_and_drops_unresolved_pairs():
    dev = FakeDeviceClock()
    tr = Tracer(clock=FakeClock(), device_clock=dev)
    with tr.device_span("decode.device"):
        pass
    tr.reset()
    assert dev.anchors == 2 and not tr._pending
    assert tr.device_seconds == {} and tr.resolve() == 0


def test_phase_snapshot_takes_device_phases_from_the_events():
    dev = FakeDeviceClock()
    tr = Tracer(clock=FakeClock(), device_clock=dev)
    with tr.span("step"):                      # host 3 .. 10
        with tr.span("plan"):                  # 4 .. 5
            pass
        with tr.device_span("prefill.device"):  # host 6 .. 7
            dev.t += 2.0
        with tr.device_span("decode.device"):   # host 8 .. 9
            dev.t += 0.5
    snap = phase_snapshot(tr)                  # resolves: one synchronize
    assert dev.syncs == 1
    assert snap == {"step_time_s": 7.0, "plan_time_s": 1.0,
                    "draft_time_s": 0.0, "prefill_time_s": 2.0,
                    "decode_time_s": 0.5, "verify_time_s": 0.0}


def test_without_a_device_clock_a_device_span_is_a_host_span():
    tr = Tracer(clock=FakeClock())
    with tr.device_span("decode.device"):
        pass
    assert tr.phase_seconds == {"decode.device": 1.0}
    assert tr.resolve(wait=True) == 0 and tr.device_seconds == {}
    assert all(e[2] == ENGINE_TRACK for e in tr.events)


# ---------------------------------------------------------------------------
# The disabled path and the profiler predicate
# ---------------------------------------------------------------------------

def test_null_tracer_records_nothing_and_shares_one_span():
    a = NULL_TRACER.span("step")
    assert a is NULL_TRACER.span("decode.device", rows=2)
    assert a is NULL_TRACER.device_span("prefill.device")
    assert a is profile_range("moe.sorted")
    with a, NULL_TRACER.device_span("decode.device"):
        NULL_TRACER.instant("x")
        NULL_TRACER.counter("y", 1)
    assert NULL_TRACER.events == () and NULL_TRACER.resolve(wait=True) == 0
    assert NULL_TRACER.device_seconds == {} and NULL_TRACER.phase_seconds == {}
    assert phase_snapshot(NULL_TRACER)["decode_time_s"] == 0.0


def test_spans_are_profiler_ranges_only_while_a_profile_is_active():
    tr = Tracer(clock=FakeClock())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert NULL_TRACER.span("null.span") is not NULL_TRACER.span("x")
        with NULL_TRACER.span("null.span"), tr.span("traced.span"), \
                tr.device_span("traced.device"), profile_range("a.range"):
            torch.ones(4).sum()
    names = _range_names(prof)
    assert {"null.span", "traced.span", "traced.device", "a.range"} <= names
    # the profile over: the shared no-op span again
    assert NULL_TRACER.span("null.span") is NULL_TRACER.span("x")


# ---------------------------------------------------------------------------
# Ranges of the engine in a CPU profile
# ---------------------------------------------------------------------------

def _chunked_cfg(**kw):
    return ServeConfig(max_batch=2, max_seq_len=64, max_new_tokens=4,
                       decode_steps=2, page_size=8, prefill_chunk_tokens=8,
                       **kw)


@pytest.mark.parametrize("trace", [False, True])
def test_engine_phases_are_ranges_of_a_cpu_profile(trace):
    cfg = get_config("qwen2.5-14b", smoke=True)
    eng = ServingEngine(cfg, _chunked_cfg(trace=trace), device="cpu")
    prompts = _prompts(np.random.default_rng(1), cfg.vocab_size, [20, 11])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.generate(prompts, 4)
    names = _range_names(prof)
    assert {"step", "step.plan", "admit", "step.submit", "prefill.chunk",
            "prefill.device", "decode.device", "step.retire"} <= names
    assert "moe.sorted" not in names            # qwen has no MoE


def test_moe_sorted_route_is_a_range_of_a_cpu_profile():
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    eng = ServingEngine(cfg, _chunked_cfg(), device="cpu")
    prompts = _prompts(np.random.default_rng(2), cfg.vocab_size, [12])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.generate(prompts, 3)
    evs = [e for e in prof.events()
           if e.name in ("moe.sorted", "prefill.chunk")]
    chunks = [e for e in evs if e.name == "prefill.chunk"]
    sorted_ = [e for e in evs if e.name == "moe.sorted"]
    assert len(chunks) == 2                     # 12 tokens in chunks of 8
    # every MoE layer of each chunk, inside the chunk's range
    assert len(sorted_) == len(chunks) * cfg.num_layers
    assert all(any(c.time_range.start <= s.time_range.start
                   and s.time_range.end <= c.time_range.end for c in chunks)
               for s in sorted_)


# ---------------------------------------------------------------------------
# Traced engine runs
# ---------------------------------------------------------------------------

def test_engine_has_no_fences():
    assert not hasattr(ServingEngine, "_fence")
    src = inspect.getsource(engine_mod)
    assert "_fence" not in src and "cuda.synchronize" not in src
    cfg = get_config("qwen2.5-14b", smoke=True)
    eng = ServingEngine(cfg, _chunked_cfg(trace=True), device="cpu")
    assert not hasattr(eng, "_fence")


def test_traced_engine_resolves_device_pairs_after_retire(monkeypatch):
    dev = FakeDeviceClock(auto=True)
    monkeypatch.setattr(engine_mod, "device_clock", lambda device: dev)
    cfg = get_config("qwen2.5-14b", smoke=True)
    eng = ServingEngine(cfg, _chunked_cfg(trace=True), device="cpu")
    tr = eng.tracer
    assert dev.anchors == 1
    for p in _prompts(np.random.default_rng(4), cfg.vocab_size, [20, 11]):
        eng.submit(p, 4)
    while True:
        retiring = eng._inflight is not None
        busy = eng.step()
        if retiring:
            assert not tr._pending      # resolved right after retire
        if not busy:
            break
    assert dev.syncs == 0               # nothing waited on the card
    host = {n: c for n, c in tr.phase_counts.items() if n.endswith(".device")}
    on_dev = [e[1] for e in tr.events if e[2] == DEVICE_TRACK]
    assert host["prefill.device"] >= 3 and host["decode.device"] >= 2
    assert {n: on_dev.count(n) for n in host} == host
    s = eng.metrics.summary()
    assert s["decode_time_s"] > 0 and s["prefill_time_s"] > 0
    assert s["decode_tokens_per_sec"] > 0
    assert "other_time_s" not in s and "host_overhead_frac" not in s


def test_traced_run_balances_through_chunks_and_preemption(tmp_path):
    """Page pressure evicts mid-run (mid-prefill too): every lifecycle
    span closes, the trace loads as JSON, and the tokens are the untraced
    engine's."""
    cfg = get_config("qwen2.5-14b", smoke=True)
    base = ServeConfig(max_batch=2, max_seq_len=32, max_new_tokens=12,
                       decode_steps=2, kv_layout="paged", page_size=4,
                       num_pages=12, prefill_chunk_tokens=4)
    prompts = _prompts(np.random.default_rng(11), cfg.vocab_size, [14, 15])
    traced = ServingEngine(cfg, base.replace(trace=True), device="cpu")
    outs = traced.generate(prompts, 12)
    tr = traced.tracer
    assert traced.metrics.preemptions >= 1
    assert tr.open_spans() == []
    names = {e[1] for e in tr.events}
    assert {"prefill.chunk", "request.preempt", "queued", "prefill",
            "decode", "request.complete"} <= names
    assert any(e[0] == "X" and e[5] and e[5].get("preempted")
               for e in tr.events)
    path = traced.save_trace(str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    assert all({"ph", "ts", "pid", "tid"} <= set(e)
               for e in doc["traceEvents"])
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {request_track(r) for r in range(len(prompts))} <= tracks
    untraced = ServingEngine(cfg, base, params=traced.params, device="cpu")
    assert outs == untraced.generate(prompts, 12)


def test_traced_cpu_engine_reports_host_seconds_for_device_phases():
    """The CPU has no device clock: the summary's device phases are their
    host spans' seconds, so a traced CPU run still reports them."""
    cfg = get_config("qwen2.5-14b", smoke=True)
    eng = ServingEngine(cfg, _chunked_cfg().replace(trace=True),
                        device="cpu")
    eng.generate(_prompts(np.random.default_rng(3), cfg.vocab_size, [5, 9]),
                 6)
    tr = eng.tracer
    assert tr.device_clock is None and tr.device_seconds == {}
    s = eng.metrics.summary()
    assert s["decode_time_s"] > 0 and s["prefill_time_s"] > 0
    assert s["decode_time_s"] == tr.phase_seconds["decode.device"]
    assert s["decode_tokens_per_sec"] > 0 and s["prefill_tokens_per_sec"] > 0


def test_untraced_engine_records_nothing():
    cfg = get_config("qwen2.5-14b", smoke=True)
    eng = ServingEngine(cfg, _chunked_cfg(), device="cpu")
    eng.generate(_prompts(np.random.default_rng(0), cfg.vocab_size, [5, 9]),
                 4)
    assert eng.tracer is NULL_TRACER and eng.tracer.events == ()
    assert eng.save_trace("never-written.json") is None
    s = eng.metrics.summary()
    assert s["step_time_s"] == 0.0 and s["decode_time_s"] == 0.0


# ---------------------------------------------------------------------------
# ServingMetrics: bounded per-cycle samples
# ---------------------------------------------------------------------------

def test_metrics_keep_running_stats_not_every_sample():
    m = ServingMetrics(clock=FakeClock())
    n = 3 * QUEUE_HISTORY + 5
    depths = [(i * 7) % 13 for i in range(n)]
    held = [1000 + (i * 31) % 977 for i in range(n)]
    for d, h in zip(depths, held):
        m.sample_queue_depth(d)
        m.sample_kv_bytes(h, 5000)
    s = m.summary()
    assert s["queue_depth_max"] == max(depths)
    assert s["queue_depth_mean"] == pytest.approx(sum(depths) / n)
    assert s["kv_bytes_peak"] == max(held)
    assert s["kv_bytes_mean"] == pytest.approx(sum(held) / n)
    assert s["kv_bytes_slotted"] == 5000
    # the history: bounded, evenly spaced from the first cycle on
    assert QUEUE_HISTORY // 4 <= len(m.queue_depth) < QUEUE_HISTORY
    stride = m._queue_stride
    assert stride == 4 and m.queue_depth == depths[::stride]
    m.reset()
    assert m.queue_depth == [] and m.summary()["queue_depth_max"] == 0


def test_metrics_history_is_exact_below_its_bound():
    m = ServingMetrics(clock=FakeClock())
    for d in range(100):
        m.sample_queue_depth(d)
    assert m.queue_depth == list(range(100))
    assert m.summary()["kv_bytes_peak"] == 0


# ---------------------------------------------------------------------------
# On the card (``cuda`` marker):
#   PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_obs.py
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_traced_engine_on_the_card_times_device_phases_by_events(tmp_path):
    """Qwen's smoke preset at a head dim the kernels take, chunked prefill
    and decode graphs: the device track holds one interval per device
    span, in order on the tracer's clock, resolved with no synchronize;
    the tokens are the untraced engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (stream events on the card; run "
                    "on the card with `pytest -m cuda`)")
    cfg = get_config("qwen2.5-14b", smoke=True).replace(
        head_dim=64, compute_dtype="bfloat16")
    scfg = ServeConfig(max_batch=4, max_seq_len=64, prefill_chunk_tokens=16)
    prompts = _prompts(np.random.default_rng(5), cfg.vocab_size, [40, 11, 35])
    eng = ServingEngine(cfg, scfg.replace(trace=True), seed=0,
                        device=torch.device("cuda"))
    dev = eng.tracer.device_clock
    syncs = []
    dev.synchronize = lambda: syncs.append(1)
    t_build = time.perf_counter()
    outs = eng.generate(prompts, 8)
    assert not syncs and not eng.tracer._pending
    tr = eng.tracer
    spans = [e for e in tr.events if e[2] == DEVICE_TRACK]
    hosts = {n: c for n, c in tr.phase_counts.items() if n.endswith(".device")}
    assert {n: sum(e[1] == n for e in spans) for n in hosts} == hosts
    assert hosts["prefill.device"] >= 5 and hosts["decode.device"] >= 2
    starts = [e[3] for e in spans]
    assert starts == sorted(starts)
    assert t_build <= starts[0] and starts[-1] <= time.perf_counter()
    assert all(e[4] >= 0 for e in spans)
    for a, b in zip(spans, spans[1:]):        # one stream: no overlap
        assert a[3] + a[4] <= b[3] + 1e-6
    s = eng.metrics.summary()
    assert s["decode_time_s"] > 0 and s["prefill_time_s"] > 0
    json.loads(open(eng.save_trace(str(tmp_path / "t.json"))).read())
    plain = ServingEngine(cfg, scfg, params=eng.params,
                          device=torch.device("cuda"))
    assert outs == plain.generate(prompts, 8)
