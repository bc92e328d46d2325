"""The K-EXAONE cell's benchmark side at smoke size on the CPU: its
configuration file against the program's configuration, the work counts
of ``core/work_hybrid.py``, its four readers, a whole run of a smoke cell
through the harness, and the check against a broken program and against
the fp8 control."""
import json
import time
from pathlib import Path

import pytest
import torch

import smoke
from bench.core import check, spec as spec_mod, work_hybrid as wh
from bench.core.cell import Cell, run_cell
from bench.core.traffic import SessionTraffic
from bench.reference import exaone_moe as ref
from repro_torch.configs import get_config
from repro_torch.configs import k_exaone_236b_a23b as kx
from repro_torch.models import attention, registry

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "bench/configs/k-exaone-236b-a23b.json").read_text())
#: smoke limits, set from readings on seeds 1-3 (program 0.0 for both
#: numbers in float32-exact agreement; the control well above)
SMOKE_LIMITS = {"logit_gap": 0.03, "mean_gap": 0.002}


def smoke_config(limit: float = 0.05) -> dict:
    """The share's smoke configuration as a configuration file (the
    benchmark's smoke helper maps non-MLA archs to the dense reference)."""
    mc = get_config(kx.SHARE_ID, smoke=True)
    L = mc.num_layers
    return {"arch": kx.SHARE_ID, "dtype": "bfloat16",
            "reference": "exaone_moe",
            "hidden_size": mc.d_model, "num_hidden_layers": L,
            "num_attention_heads": mc.num_heads,
            "num_key_value_heads": mc.num_kv_heads,
            "head_dim": mc.resolved_head_dim,
            "intermediate_size": mc.d_ff_dense,
            "moe_intermediate_size": mc.moe.d_ff_expert,
            "num_experts": mc.moe.held, "router_experts": mc.moe.num_experts,
            "num_experts_per_tok": mc.moe.top_k,
            "num_shared_experts": mc.moe.num_shared_experts,
            "routed_scaling_factor": mc.moe.routed_scaling,
            "layer_types": ["full_attention" if mc.layer_kind(i) == "G"
                            else "sliding_attention" for i in range(L)],
            "mlp_layer_types": ["dense" if i < mc.first_dense_layers
                                else "sparse" for i in range(L)],
            "sliding_window": mc.window,
            "rope_parameters": {"rope_theta": mc.rope_theta},
            "rms_norm_eps": mc.norm_eps, "vocab_size": mc.vocab_size,
            "check": {"logit_gap": limit, "mean_gap": limit}}


def mixed(rate: float = 4.0) -> dict:
    """Single-turn unshared requests of mixed lengths, chunks of 32 over
    the smoke window of 8."""
    serve = dict(smoke.SERVE, enable_prefix_cache=False,
                 prefill_chunk_tokens=32)
    return {"arrivals": {"kind": "poisson", "rate_per_s": rate},
            "turns": {"min": 1, "max": 1}, "history": False,
            "shared_prefix_tokens": 0,
            "user_tokens": {"median": 24, "sigma": 1.0, "min": 4,
                            "max": 90},
            "answer_tokens": {"median": 6, "sigma": 0.3, "min": 3, "max": 9},
            "think_s": {"mean": 0.0}, "base_seed": 0, "preroll_s": 0.3,
            "serve": serve, "check": {"max_requests": 4}}


def test_configuration_file_is_the_programs():
    """Every width and kind the file states is the share's ModelConfig's,
    and the cut is the held experts alone."""
    mc = get_config(CFG["arch"])
    m = mc.moe
    assert CFG["reduced"] == ["num_experts", "num_nextn_predict_layers"]
    assert (CFG["hidden_size"], CFG["num_hidden_layers"],
            CFG["num_attention_heads"], CFG["num_key_value_heads"],
            CFG["head_dim"], CFG["vocab_size"]) == (
        mc.d_model, mc.num_layers, mc.num_heads, mc.num_kv_heads,
        mc.resolved_head_dim, mc.vocab_size)
    assert (CFG["intermediate_size"], CFG["moe_intermediate_size"],
            CFG["num_experts"], CFG["router_experts"],
            CFG["num_experts_per_tok"], CFG["num_shared_experts"],
            CFG["routed_scaling_factor"], CFG["scoring_func"]) == (
        mc.d_ff_dense, m.d_ff_expert, m.held, m.num_experts, m.top_k,
        m.num_shared_experts, m.routed_scaling, m.scoring)
    assert CFG["published"]["num_experts"] == m.num_experts
    assert CFG["layer_types"] == [
        "full_attention" if mc.layer_kind(i) == "G" else "sliding_attention"
        for i in range(mc.num_layers)]
    assert CFG["sliding_windows"] == [
        0 if mc.layer_kind(i) == "G" else mc.window
        for i in range(mc.num_layers)]
    assert CFG["mlp_layer_types"].count("dense") == mc.first_dense_layers
    assert (CFG["rms_norm_eps"], CFG["rope_parameters"]["rope_theta"],
            CFG["sliding_window"]) == (mc.norm_eps, mc.rope_theta, mc.window)
    shapes = ref.param_shapes(CFG)
    n = sum(int(torch.tensor(s).prod()) for s in _leaves(shapes))
    assert n == registry.count_params(mc) == 23_668_285_312


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("s,c", [(0, 5), (0, 200), (3, 10), (100, 60),
                                 (128, 512), (7, 121)])
def test_window_pairs_count_each_query_once(s, c):
    w = 128
    assert wh.window_pairs(s, c, w) == sum(min(p + 1, w)
                                           for p in range(s, s + c))


def test_body_flops_are_twice_the_parameters_a_token_runs():
    """2 x (every parameter outside the table, head and routed experts)
    + the expected held picks' share of the routed experts."""
    mc = get_config(CFG["arch"])
    d = wh.dims(CFG)
    per_expert = 3 * mc.d_model * mc.moe.d_ff_expert
    n_moe = mc.num_layers - mc.first_dense_layers
    outside = (registry.count_params(mc) - 2 * mc.vocab_size * mc.d_model
               - n_moe * mc.moe.held * per_expert)
    # the norms' scales and the correction biases: no products
    norms = mc.d_model * (2 * mc.num_layers + 1) + 2 * mc.resolved_head_dim \
        * mc.num_layers + n_moe * mc.moe.num_experts
    picks = mc.moe.top_k * mc.moe.held / mc.moe.num_experts
    want = 2.0 * (outside - norms + n_moe * picks * per_expert)
    assert wh.body_flops(d) == pytest.approx(want, rel=1e-12)
    assert (d["Lg"], d["Lw"], d["W"]) == (12, 36, 128)


def test_prefill_seconds_split_by_ring_argument():
    """K2 and K5 share the tensor-core body's symbol: its RING argument
    tells them apart, and a split merge counts with the launch before."""
    k = [("void repro_torch::paged_prefill_wgmma_kernel<true, "
          "__nv_bfloat16, 128>(...)", 0.0, 10.0),
         ("void repro_torch::prefill_merge_kernel<128>(...)", 11.0, 12.0),
         ("void repro_torch::paged_prefill_wgmma_kernel<false, "
          "__nv_bfloat16, 128>(...)", 20.0, 40.0),
         ("void repro_torch::prefill_merge_kernel<128>(...)", 41.0, 44.0),
         ("void repro_torch::paged_decode_kernel<...>", 50.0, 60.0)]
    glob, ring = wh.prefill_seconds({"kernels": k})
    assert (glob, ring) == (23e-6, 11e-6)


@pytest.mark.parametrize("name", ["mfu.hybrid", "hybrid_decode_roofline",
                                  "global_prefill_roofline",
                                  "ring_prefill_roofline"])
def test_readers_find_nothing_without_a_trace(name):
    from types import SimpleNamespace
    ctx = SimpleNamespace(config=CFG, red=None, counters={})
    assert spec_mod.reader(ROOT, name)(ctx) is None


def test_readers_on_a_synthetic_slice():
    """One 512-token chunk at start 1,024 and one decode step of two
    slots; each kernel given exactly its least time reads 100%."""
    from types import SimpleNamespace
    import numpy as np
    d = wh.dims(CFG)
    chunks = [(1024, 512)]
    groups = [[(np.arange(700), 700), (np.arange(100) + 5, 100)]]
    tg = wh.global_prefill_time(d, chunks) * 1e6
    tr = wh.ring_prefill_time(d, chunks) * 1e6
    td = wh.decode_time(d, groups) * 1e6
    red = {"kernels": [
        ("paged_prefill_wgmma_kernel<false, bf16, 128>", 0.0, tg),
        ("paged_prefill_wgmma_kernel<true, bf16, 128>", tg, tg + tr),
        ("paged_decode_kernel<bf16>", tg + tr, tg + tr + td)],
        "launches": 3}
    ctx = SimpleNamespace(config=CFG, red=red, wall=1.0, chunks=chunks,
                          groups=groups, first_tokens=1, counters={})
    for name in ("hybrid_decode_roofline", "global_prefill_roofline",
                 "ring_prefill_roofline"):
        assert spec_mod.reader(ROOT, name)(ctx) == pytest.approx(100.0)
    mfu = spec_mod.reader(ROOT, "mfu.hybrid")(ctx)
    assert 0 < mfu < 100


def _run(traffic, seed=2**31 + 31, trace=False, per_layer=()):
    e2e = [{"name": n, "unit": "u"} for n in ("serve_tok_s", "tpot_p95_ms",
                                              "setup_s")]
    spec = smoke.spec(smoke_config(), traffic, e2e, per_layer)
    return run_cell(spec, seed, 1.5, trace, t_start=time.perf_counter(),
                    device="cpu", smoke=True)


def test_smoke_cell_end_to_end():
    bench = spec_mod.load(ROOT)
    per_layer = [dict(m, workloads=["smoke"]) for m in bench["per_layer"]
                 if "kexaone-mixed" in m["workloads"]]
    r = _run(mixed(), trace=True, per_layer=per_layer)
    assert r["correct"] is True and r["sample"]["tokens"] > 0
    got = r["metrics"]
    # the CPU runs no kernel: the rooflines find nothing and stay out
    assert not {"hybrid_decode_roofline", "global_prefill_roofline",
                "ring_prefill_roofline"} & set(got)
    assert got["mfu.hybrid"]["value"] > 0


def test_rope_on_every_layer_is_not_correct(monkeypatch):
    """A program that rotates the global layers' q and k too (the block's
    one positional difference between the two kinds) comes out not
    correct."""
    norm_rope = attention.norm_rope

    def everywhere(cfg, p, t, positions, which):
        return norm_rope(cfg.replace(rope_layers="all"), p, t, positions,
                         which)
    monkeypatch.setattr(attention, "norm_rope", everywhere)
    r = _run(mixed())
    assert r["correct"] is False


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_where_the_program_passes(seed):
    limits = {k: SMOKE_LIMITS[k] for k in CFG["check"]}
    cell = Cell(smoke_config(), mixed(), device="cpu", smoke=True)
    cell.load(seed)
    reqs = SessionTraffic(cell.traffic, seed, cell.config["vocab_size"],
                          cell.serve_cfg.max_seq_len, 0.0, 2.0).pop_due(2.0)
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
