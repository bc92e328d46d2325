"""The check against a broken program: at smoke size on the CPU, a run
with the timed path broken underneath must come out not correct, and the
control (the reference in fp8 in the program's place) must come out not
correct under the configuration's own check while the program comes out
correct.  On a card (``cuda`` marker) the control runs at the cell's own
size, under the cell's own limits:

    python3 -m pytest -m cuda -s bench/tests/test_bench_faults.py
"""
import json
import time
from pathlib import Path

import pytest
import torch

import smoke
from bench import calibrate
from bench.core import check, spec as spec_mod
from bench.core.cell import Cell, run_cell
from bench.core.traffic import SessionTraffic
from repro_torch.models import attention
from repro_torch.serving.engine import ServingEngine

ROOT = Path(__file__).resolve().parents[2]
LIMIT = 0.05
#: limits for the smoke sizes (width 64, vocab 256), set from their
#: readings on seeds 1-3: the program 0.0 for both numbers; the control
#: 0.065-0.30 (widest gap) and 0.0041-0.0188 (mean gap)
SMOKE_LIMITS = {"logit_gap": 0.03, "mean_gap": 0.002}


def run(arch, traffic, seed=2**31 + 21):
    spec = smoke.spec(smoke.config(arch, LIMIT), traffic)
    return run_cell(spec, seed, 1.5, False, t_start=time.perf_counter(),
                    device="cpu", smoke=True)


CELLS = [("qwen2.5-14b", smoke.chat), ("deepseek-v2-lite-16b", smoke.batch)]


@pytest.mark.parametrize("arch,traffic", CELLS)
def test_token_altered_where_produced(monkeypatch, arch, traffic):
    emit = ServingEngine._emit

    def altered(self, req, token, stream):
        if len(req.tokens) % 3 == 1:
            token = (int(token) + 1) % self.model_cfg.vocab_size
        return emit(self, req, token, stream)
    monkeypatch.setattr(ServingEngine, "_emit", altered)
    r = run(arch, traffic())
    assert r["correct"] is False
    assert r["check"]["logit_gap"]["value"] > LIMIT


@pytest.mark.parametrize("arch,traffic,fn", [
    ("qwen2.5-14b", smoke.chat, "paged_cache_update"),
    ("deepseek-v2-lite-16b", smoke.batch, "paged_latent_update")])
def test_decode_step_leaves_its_state_unchanged(monkeypatch, arch, traffic,
                                                fn):
    monkeypatch.setattr(attention, fn, lambda kv, *a, **k: kv)
    r = run(arch, traffic())
    assert r["correct"] is False


@pytest.mark.parametrize("arch,traffic", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_where_the_program_passes(arch, traffic, seed):
    """The first requests of the cell's traffic, served by the program's
    engine (no clock involved), are correct under the numbers that the
    configuration's ``check`` names (smoke limits); the control on the
    same prompts and tokens is not."""
    names = json.loads((ROOT / "bench" / "configs" /
                        f"{arch}.json").read_text())["check"]
    limits = {k: SMOKE_LIMITS[k] for k in names}
    cell = Cell(smoke.config(arch, LIMIT), traffic(), device="cpu",
                smoke=True)
    cell.load(seed)
    reqs = SessionTraffic(cell.traffic, seed, cell.config["vocab_size"],
                          cell.serve_cfg.max_seq_len, 0.0, 1.0).pop_due(1.0)
    reqs = reqs[:4]
    outs = cell.session.serve([r.prompt.tolist() for r in reqs],
                              max_new=12, serve_cfg=cell.serve_cfg)
    for r, o in zip(reqs, outs):
        r.tokens = list(o)
    cell.free()
    got = check.compare(cell.ref, cell.config, cell.weights, reqs,
                        control=True)
    assert check.judge(got, limits)
    assert not check.judge(check.control_readings(got), limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec_mod.load(ROOT)["workloads"]])
def test_control_is_not_correct_at_the_cells_size(workload):
    """Each cell at its own size and under its own check: on three seeds
    the program comes out correct and the control (fp8) does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's full-size model "
                    "(run on the card with `pytest -m cuda`)")
    spec = spec_mod.cell(ROOT, workload)
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    for out in calibrate.readings(spec, seeds, 15.0):
        print(workload, json.dumps(out), flush=True)
        assert out["program"]["correct"] is True, out
        assert out["control"]["correct"] is False, out
