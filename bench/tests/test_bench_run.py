"""A whole run at smoke size on the CPU, through the harness's own
functions past its look for a card: the result line's keys, each family
end to end, and the traced run's per-layer readings."""
import json
import time
from pathlib import Path

import pytest

import smoke
from bench.core import spec as spec_mod
from bench.core.cell import run_cell

ROOT = Path(__file__).resolve().parents[2]
E2E = [{"name": n, "unit": "u"} for n in
       ("serve_tok_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s")]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(arch, traffic, trace=False, per_layer=(), seed=2**31 + 11):
    spec = smoke.spec(smoke.config(arch), traffic, E2E, per_layer)
    return run_cell(spec, seed, 1.5, trace, t_start=time.perf_counter(),
                    device="cpu", smoke=True)


@pytest.mark.parametrize("arch,traffic", [
    ("qwen2.5-14b", smoke.chat()), ("deepseek-v2-lite-16b", smoke.batch())])
def test_run_end_to_end(arch, traffic):
    r = run(arch, traffic)
    keys = list(r)
    assert keys[:5] == KEYS and keys[-1] == "check"
    json.loads(json.dumps(r))                      # one JSON line
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in E2E}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    chk = r["check"]["logit_gap"]
    assert chk["value"] <= chk["limit"] and r["sample"]["tokens"] >= 20
    assert r["device"]["platform"] == "cpu"        # never a device metric


def test_traced_run_reads_layers():
    bench = spec_mod.load(ROOT)
    per_layer = [dict(m, workloads=["smoke"]) for m in bench["per_layer"]
                 if "qwen14b-chat" in m["workloads"]]
    r = run("qwen2.5-14b", smoke.chat(rate=6.0), trace=True,
            per_layer=per_layer)
    assert list(r)[-1] == "check" and r["correct"] is True
    assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    got = r["metrics"]
    # the CPU has no kernels: the rooflines find nothing and stay out
    assert "paged_attention_roofline" not in got
    assert 0 < got["prefix_hit_share"]["value"] < 100
    assert got["mfu.tpot"]["value"] > 0


def test_cells_of_the_benchmark_resolve():
    """Each cell finds its configuration, traffic and metric readers."""
    bench = spec_mod.load(ROOT)
    for w in bench["workloads"]:
        c = spec_mod.cell(ROOT, w["name"])
        assert c["config"]["arch"] and c["traffic"]["serve"]
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in names
            assert callable(spec_mod.reader(ROOT, m["name"]))
