"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* **Single-device cells against JAX.**  qwen, stablelm and rwkv6 smoke
  prefill (2 x 64) and decode (2 at 64): the fake run's ``dot_flops``
  against ``analyze_module`` of the JAX bundle's jitted, compiled
  ``prefill_fn`` / ``decode_fn`` (bf16 weights, as the reference's serve
  cells).  Decode and rwkv6's prefill agree exactly.  The attention
  families' prefill differs by exactly one thing, stated in the test: the
  port projects K and V a second time for the cache (``layers_forward``
  re-runs ``wk`` / ``wv`` after attention, as the JAX source does), and
  XLA's common-subexpression pass folds that duplicate into the first,
  eager PyTorch does not — 2 x tokens x d_model x (2 x KV x hd) per layer.
  MoE is left out by design: the JAX package computes its serving routes
  as dense GShard groups, whose dispatch einsums are not the port's.
* **Meshed cells against a real run.**  On jax 0.9.0 the reference cannot
  lower a meshed serve cell (``ShardingTypeError`` in the embedding
  gather), so meshed cells are held to the port itself: qwen smoke
  decode, prefill and train (``fsdp``, ``zero1``) and rwkv6 decode on a
  2x2 mesh, run for real in 4 gloo processes under the op counter
  (``tests/torch_mesh_worker.py:run_dryrun_cells``), and the fake run of
  each rank in this process: kind, buffer bytes, group size, count and
  issuing function of every collective must be equal, rank by rank.
* **A production cell.**  ``qwen2.5-14b`` ``decode_32k`` on the single-pod
  mesh (256 fake ranks) finishes in process; rank 0's weight bytes equal
  the rules' shards, and the record has the reference's keys.
"""
import math
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_dp_worker
import torch_mesh_worker
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.models import registry as jax_registry
from repro.roofline.hlo_parse import analyze_module
from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.models.common import logical_to_mesh, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600
ONE = MeshConfig(shape=(1, 1), axis_names=("data", "model"))
SMOKE_SHAPES = {"prefill": (64, 2), "decode": (64, 2)}


def _jax_dot_flops(arch, kind):
    cfg = jax_config(arch, smoke=True)
    b = jax_registry.build(cfg)
    seq, batch = SMOKE_SHAPES[kind]
    shape = JaxShape(kind, kind, seq, batch)
    bf16 = lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating)
        else s.dtype)
    params = jax.tree.map(bf16, b.param_structs())
    if kind == "prefill":
        low = jax.jit(lambda p, i: b.prefill_fn(p, **i)).lower(
            params, b.prefill_input_specs(shape))
    else:
        low = jax.jit(b.decode_fn).lower(
            params, jax.ShapeDtypeStruct((batch, 1), jnp.int32),
            b.decode_state_specs(shape))
    return analyze_module(low.compile().as_text()).dot_flops


def _port_cell(arch, kind):
    seq, batch = SMOKE_SHAPES[kind]
    with dryrun.fake_world(1), FakeTensorMode():
        cell = dryrun.lower_cell(arch, ShapeConfig(kind, kind, seq, batch),
                                 "single", "serve",
                                 cfg=get_config(arch, smoke=True),
                                 mesh_cfg=ONE)
        return dryrun.run_cell(cell)


def _cache_reprojection(arch, kind):
    """The prefill's second K / V projection for the cache (attention
    families): 2 x tokens x d_model x (2 x KV x hd), every layer."""
    cfg = get_config(arch, smoke=True)
    if kind != "prefill" or cfg.family == "ssm":
        return 0
    seq, batch = SMOKE_SHAPES[kind]
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    return 2 * batch * seq * cfg.d_model * 2 * kv * cfg.num_layers


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "stablelm-1.6b",
                                  "rwkv6-1.6b"])
def test_single_device_dot_flops_equal_jax(arch, kind):
    counter, memory, _, n_ops = _port_cell(arch, kind)
    want = _jax_dot_flops(arch, kind) + _cache_reprojection(arch, kind)
    assert counter.stats.dot_flops == want
    assert counter.stats.collectives == []
    assert memory["peak_estimate_bytes"] >= memory["argument_bytes"] > 0
    assert n_ops > 0 and counter.stats.hbm_bytes > 0


# ---------------------------------------------------------------------------
# Meshed: the fake run of each rank against a real 4-process gloo run
# ---------------------------------------------------------------------------

QWEN = "qwen2.5-14b"
MESH_CELLS = {
    "qwen/decode": (QWEN, ShapeConfig("d", "decode", 32, 4), "serve"),
    "qwen/prefill": (QWEN, ShapeConfig("p", "prefill", 32, 4), "serve"),
    "qwen/train_fsdp": (QWEN, ShapeConfig("t", "train", 16, 8), "fsdp"),
    "qwen/train_zero1": (QWEN, ShapeConfig("t", "train", 16, 8), "zero1"),
    "rwkv6/decode": ("rwkv6-1.6b", ShapeConfig("d", "decode", 32, 4),
                     "serve"),
}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    out = []
    ranks = threading.Thread(target=lambda: out.append(
        torch_dp_worker.spawn_world(
            torch_mesh_worker.run_dryrun_cells, 4,
            tmp_path_factory.mktemp("pg") / "pg", (MESH_CELLS,), TIMEOUT)))
    ranks.start()
    ranks.join(timeout=TIMEOUT + 60)
    assert not ranks.is_alive() and out, "mesh workers did not finish"
    if isinstance(out[0], tuple):
        pytest.fail("mesh workers failed: " + out[0][1])
    return out[0]["ranks"]


def _fake_collectives(name, rank):
    arch, shape, mode = MESH_CELLS[name]
    with dryrun.fake_world(4, rank), FakeTensorMode():
        cell = dryrun.lower_cell(arch, shape, "single", mode,
                                 cfg=get_config(arch, smoke=True),
                                 mesh_cfg=torch_mesh_worker.MESH_2X2)
        return torch_mesh_worker.collective_key(dryrun.run_cell(cell)[0].stats)


@pytest.mark.parametrize("name", sorted(MESH_CELLS))
def test_meshed_collectives_equal_the_gloo_run(gloo_run, name):
    for rank in range(4):
        got = _fake_collectives(name, rank)
        assert got, f"{name}: no collective counted on rank {rank}"
        assert got == gloo_run[rank][name], f"{name}, rank {rank}"


# ---------------------------------------------------------------------------
# One full-config production cell
# ---------------------------------------------------------------------------

def _expected_param_bytes(cfg, mesh_sizes):
    rules, _ = dryrun._serve_param_rules(cfg, dryrun._mesh_cfg("single"))
    specs = registry.build(cfg).specs
    total = 0
    for s, pl in zip(tree_leaves(specs), tree_leaves(
            logical_to_mesh(specs, rules))):
        n = math.prod(s.shape)
        for entry in pl:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= mesh_sizes[a]
        total += n * 2                      # bf16 serve weights
    return total


@pytest.fixture(scope="module")
def production_cell():
    return dryrun.analyze_cell(QWEN, "decode_32k", "single", "serve")


def test_production_decode_cell_in_process(production_cell):
    cfg = get_config(QWEN)
    rec, stats, cell = production_cell
    got = sum(t.numel() * t.element_size()
              for t in tree_leaves(cell.arguments[0]))
    assert got == _expected_param_bytes(cfg, {"data": 16, "model": 16})
    state = sum(t.numel() * t.element_size()
                for t in tree_leaves(cell.arguments[2]))
    assert rec["memory"]["argument_bytes"] == got + state + 8 * 4  # tokens
    # one all-reduce a layer (the MLP's row-parallel sum; 40 / 8 heads do
    # not divide 16, so attention replicates) and the logits' gather
    summ = stats.collective_summary()
    assert summ["all-reduce"]["count"] == cfg.num_layers
    assert summ["all-gather"]["count"] == 1
    assert {c.group_size for c in stats.collectives} == {16}
    assert rec["hlo_stats"]["wire_bytes_by_group"] == {
        16: stats.wire_bytes_total}
    assert not dist.is_initialized()


def test_record_keys_and_list(production_cell):
    rec = production_cell[0]
    assert set(rec) >= {"arch", "shape", "mesh", "mode", "devices",
                        "lower_s", "compile_s", "memory", "xla_cost",
                        "hlo_stats", "model_flops_global", "params_total",
                        "params_active", "hlo_bytes_len", "overrides"}
    assert rec["devices"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_estimate_bytes"}
    m = rec["memory"]
    assert m["peak_estimate_bytes"] == (m["argument_bytes"]
                                        + m["output_bytes"]
                                        + m["temp_bytes"] - m["alias_bytes"])
    assert rec["model_flops_global"] == registry.model_flops(
        get_config(QWEN), dryrun.get_shape("decode_32k"))
    cells = list(dryrun.all_cells())
    assert (QWEN, "train_4k", "single", "fsdp") in cells
    assert not any(c[1] == "long_500k" and c[0] == QWEN for c in cells)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--list"], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0
    assert out.stdout.strip().endswith(f"total: {len(cells)} dry-run cells")


def test_profile_cell_prints_the_production_cell(production_cell, capsys):
    """``profile_cell``'s dry-run printout of the cell: the three terms
    (compute, memory, collective at the 16-rank group's InfiniBand rate)
    and the contributors, heaviest first."""
    from repro_torch.roofline import hw, profile_cell
    rec, stats, _ = production_cell
    t = profile_cell.print_dry_run("qwen decode_32k", stats,
                                   rec["memory"]["peak_estimate_bytes"], 3)
    out = capsys.readouterr().out
    # bf16 weight matmuls at the tensor cores' rate, the plain attention's
    # fp32 ones at the CUDA cores'
    assert 0 < stats.fp32_flops < stats.flops
    assert t["compute_s"] == pytest.approx(
        (stats.flops - stats.fp32_flops) / hw.PEAK_FLOPS_BF16
        + stats.fp32_flops / hw.PEAK_FLOPS_FP32)
    assert t["collective_s"] == stats.wire_bytes_total / hw.IB_BW
    assert "top FLOP contributors" in out and "all-reduce" in out
    assert out.count("models.") >= 6
    assert profile_cell.kernel_label(
        "void repro_torch::flash_fwd_kernel_wgmma<128, 64>(...)") == "K3"
    assert profile_cell.kernel_label(
        "void repro_torch::paged_mla_decode_kernel_mma<16, 512, 64>") == "K6"
    assert profile_cell.kernel_label("nvjet_tst_192x192") == ""


@pytest.mark.parametrize("flag", [["--microbatch", "4"],
                                  ["--rules", "embed=data"],
                                  ["--allreduce-override", "fused"]])
def test_profile_cell_card_run_refuses_mesh_overrides(flag):
    """``--device cuda`` runs one card with no mesh and no train step: the
    knobs that act only there are refused, not ignored."""
    from repro_torch.roofline import profile_cell
    with pytest.raises(SystemExit, match="do not apply"):
        profile_cell.main(["--arch", "qwen2.5-14b", "--shape", "prefill_32k",
                           "--device", "cuda", *flag])


def test_profile_cell_config_overrides_reach_the_card_cell():
    """The config knobs (remat, q_block, kv_block, attn_remat) are the
    ones ``lower_cell`` applies, and the card run takes the same config."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = dryrun.config_overrides(get_config("qwen2.5-14b"), {
        "q_block": 256, "kv_block": 1024, "attn_remat": True,
        "remat": "dots"})
    assert (cfg.attn_q_block, cfg.attn_kv_block, cfg.attn_remat,
            cfg.remat) == (256, 1024, True, "dots")
