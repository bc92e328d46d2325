"""A new cell, traffic mix and per-layer metric come as new files and new
entries only: no file the benchmark already has changes."""
import json
import re
import shutil
from pathlib import Path

from bench.core import spec as spec_mod

ROOT = Path(__file__).resolve().parents[2]


def test_add_cell_and_metric_as_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    # new data: a bursty copy of the chat mix, a new cell, a new metric
    mix = json.loads((ROOT / "bench/traffic/multiturn_chat.json").read_text())
    mix["arrivals"]["rate_per_s"] *= 0.5
    (tmp_path / "bench/traffic/half_rate_chat.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench/metrics/queue_free.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "qwen14b-halfchat",
                               "config": "qwen2.5-14b",
                               "traffic": "half_rate_chat", "chips": 1,
                               "why": "half rate"})
    bench["per_layer"].append({"name": "queue_free", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "tpot_p95_ms",
                               "workloads": ["qwen14b-halfchat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec_mod.cell(tmp_path, "qwen14b-halfchat")
    assert c["traffic"]["arrivals"]["rate_per_s"] == \
        mix["arrivals"]["rate_per_s"]
    assert [m["name"] for m in c["per_layer"]] == ["queue_free"]
    assert spec_mod.reader(tmp_path, "queue_free")(None) == 1.0
    assert {m["name"] for m in c["end_to_end"]} == {
        "serve_tok_s", "tpot_p95_ms", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_reduced_lists_each_departure_from_the_source():
    """A configuration file's ``reduced`` is its ``BENCHMARK.json`` entry's,
    and each key in it carries the source's value under ``published``,
    which differs from the value the file states and the program runs."""
    for entry in spec_mod.load(ROOT)["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"]
        assert cfg["source"] == entry["source"]
        published = cfg.get("published", {})
        assert sorted(published) == sorted(entry["reduced"])
        for key in entry["reduced"]:
            assert published[key] != cfg[key], key


WIDTH = re.compile(r"(_dim|_rank|_size|head_dim|experts_per_tok|expand)$")


def test_no_width_departs_from_the_source():
    """A key listed in ``reduced`` is never a width, and where it names a
    nested group, no width inside the group departs from the source."""
    for entry in spec_mod.load(ROOT)["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        for key in entry["reduced"]:
            assert not WIDTH.search(key), key
            published = cfg["published"][key]
            if isinstance(published, dict):
                for k, v in published.items():
                    if WIDTH.search(k):
                        assert cfg[key].get(k) == v, (key, k)
