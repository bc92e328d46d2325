"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the ``file`` of its ``configs`` entry;
* a traffic mix: ``bench/traffic/<traffic>.json`` (``core/traffic.py``
  reads it; its ``serve`` group holds the engine's ``ServeConfig`` fields);
* a per-layer metric: ``bench/metrics/<name>.py``, whose ``read(ctx)``
  returns the number or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict

def load(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(root: Path, name: str) -> Dict:
    """Everything one cell needs: its workload entry, configuration and
    traffic files, and the metrics it reports."""
    bench = load(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{work['traffic']}.json").read_text())

    def applies(m: Dict) -> bool:
        return name in m["workloads"] if "workloads" in m else True
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"root": root, "workload": work, "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer}


def reader(root: Path, name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

