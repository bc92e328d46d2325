"""Production dry run: every (arch x shape x mesh) cell run on fake tensors
on one rank of the production mesh, with its FLOPs, HBM bytes,
collectives and peak memory recorded.

The port of ``src/repro/launch/dryrun.py``.  The JAX package lowers and
compiles each cell against 512 placeholder devices and reads the HLO.  The
port runs eager, so the dry run *runs* the cell — in one process, on one
rank, with nothing computed and nothing allocated:

  * a ``torch.distributed`` process group of the production world size
    (256 for ``single``, 512 for ``multi``) on the ``fake`` backend, whose
    collectives return at once;
  * ``launch.mesh.make_production_mesh`` (16x16 or 2x16x16) and the rules
    of ``launch.sharding``, which give this rank its local shards;
  * ``FakeTensorMode``: every tensor has a shape, a dtype and a device and
    no storage, so a full-width cell runs on a laptop's CPU;
  * ``roofline.op_count.OpCounter`` over the step: FLOPs, bytes,
    collectives (group sizes from the ops' process groups) and the live
    fake bytes' high-water mark.

Train cells step ``TransparentTrainer.from_bundle`` (``paper`` /
``zero1`` / ``fsdp``, as ``TRAIN_MODES``); prefill cells call the
bundle's ``prefill_fn``, decode cells its ``decode_fn`` one token on the
cell's cache, with the bf16 serve weights of the reference
(``_serve_param_rules``).  Fake tensors launch no kernel, so every cell
runs the plain PyTorch versions (``use_kernels=False``): the same FLOPs as
the kernels, and the plain versions' bytes and memory (blocked attention
materialises one [q_block x kv_block] score tile per head at a time).

Records keep the reference's keys, in the port's meaning:
``lower_s`` is the set-up (process group, mesh, fake weights and state),
``compile_s`` the fake step; ``memory`` splits the high-water mark into
what the step found live (``argument_bytes``), what it returned
(``output_bytes``, ``alias_bytes`` the part of it written in place) and
the rest (``temp_bytes``); ``xla_cost`` holds the counter's totals (there
is no XLA); ``hlo_stats`` the counter's numbers under the reference's
names (and ``fp32_flops`` and ``wire_bytes_by_group``, which
``roofline/analysis.py`` prices at their own rates); ``hlo_bytes_len`` the number of ATen ops the step
dispatched.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # every runnable cell
  python -m repro_torch.launch.dryrun --list           # enumerate cells

One JSON per cell lands in results/dryrun_torch/; existing files are
skipped (incremental).  ``--all --subprocess`` runs each cell in a process
of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ALL_ARCHS, get_config, get_shape
from repro_torch.configs.base import (MULTI_POD, SINGLE_POD, MeshConfig,
                                      ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (build_mesh, dp_size, make_production_mesh,
                                     model_size)
from repro_torch.models import common, registry
from repro_torch.roofline import hw
from repro_torch.roofline.op_count import OpCounter

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# train-cell variants: the paper-faithful baseline and the beyond-paper modes
TRAIN_MODES = {
    "paper": dict(dp_mode="replicated", allreduce="layerwise"),
    "zero1": dict(dp_mode="replicated", allreduce="reduce_scatter"),
    "fsdp": dict(dp_mode="fsdp", allreduce="layerwise"),
}
DEFAULT_TRAIN_MODES = ("paper", "fsdp")


def runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False                   # pure full-attention: documented skip
    return True


def all_cells(train_modes=DEFAULT_TRAIN_MODES):
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            shape = get_shape(shape_name)
            if not runnable(cfg, shape):
                continue
            for mesh_name in ("single", "multi"):
                if shape.kind == "train":
                    for mode in train_modes:
                        yield (arch, shape_name, mesh_name, mode)
                else:
                    yield (arch, shape_name, mesh_name, "serve")


def _mesh_cfg(mesh_name: str, **overrides) -> MeshConfig:
    base = SINGLE_POD if mesh_name == "single" else MULTI_POD
    return dataclasses.replace(base, **overrides)


def _serve_param_rules(cfg, mesh_cfg):
    """The serve placement: the model-axis TP rules of
    ``launch.sharding.param_rules`` (weights replicated over the data
    axes).  The reference switches to a 2-D placement (embed -> data)
    when bf16 weights would not fit model-sharded; on 80 GB that happens
    for no arch of the registry, and the port's serving path has no
    data-sharded weights, so such a cell raises."""
    n_params = registry.count_params(cfg)
    per_chip = 2.0 * n_params / model_size(mesh_cfg)
    if per_chip > 0.6 * hw.HBM_BYTES:
        raise NotImplementedError(
            f"{cfg.name}: {per_chip / 1e9:.1f} GB of bf16 weights a device "
            "model-sharded; the port serves no data-sharded weights")
    return sharding.param_rules(
        dataclasses.replace(mesh_cfg, dp_mode="replicated"), cfg)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``fake``-backend default process group of ``world_size`` ranks,
    this process being ``rank``: every collective returns at once.  Torn
    down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(shape, dtype, pspec, mesh):
    """Zeros at this rank's block of ``shape`` under ``pspec`` (valid token
    ids for the integer inputs; free under ``FakeTensorMode``)."""
    shape = list(shape)
    for d, entry in enumerate(pspec):
        shape[d] //= mesh.size(entry)
    return torch.zeros(shape, dtype=dtype)


def _local_inputs(specs, mesh, dp_axes, dp):
    pspecs = sharding.serve_input_pspecs(specs, dp_axes=dp_axes, dp_total=dp)
    return {k: _local(v.shape, v.dtype, pspecs[k], mesh)
            for k, v in specs.items()}


@dataclasses.dataclass
class Cell:
    """A cell ready to run on this rank: ``step()`` runs it once;
    ``arguments`` are the tensors it finds live (weights, state, inputs)."""
    cfg: ModelConfig
    shape: ShapeConfig
    step: object
    arguments: list


#: the hillclimb knobs that change the mesh or the train step, not the
#: model config
MESH_OVERRIDES = ("microbatch", "allreduce", "rules")


def config_overrides(cfg: ModelConfig, ov: dict) -> ModelConfig:
    """``cfg`` with the hillclimb knobs that live in the model config
    (remat, q_block, kv_block, attn_remat)."""
    if ov.get("remat"):
        cfg = cfg.replace(remat=ov["remat"])
    if ov.get("q_block"):
        cfg = cfg.replace(attn_q_block=int(ov["q_block"]))
    if ov.get("kv_block"):
        cfg = cfg.replace(attn_kv_block=int(ov["kv_block"]))
    if ov.get("attn_remat"):
        cfg = cfg.replace(attn_remat=True)
    return cfg


def lower_cell(arch: str, shape_name, mesh_name: str, mode: str,
               overrides: dict = None, *, cfg: ModelConfig = None,
               mesh_cfg: MeshConfig = None) -> Cell:
    """Build a cell on this rank (call inside the process group: the fake
    one of ``fake_world``, or a real one).  overrides (hillclimb knobs):
    microbatch:int, remat:str, allreduce:str, rules:{logical->mesh axis},
    q_block, kv_block, attn_remat.  ``cfg`` replaces the arch's config
    (a smoke config) and ``mesh_cfg`` the production mesh (tests)."""
    ov = overrides or {}
    cfg = config_overrides(cfg or get_config(arch), ov)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else get_shape(shape_name))
    bundle = registry.build(cfg)
    rules_override = tuple(sorted(ov.get("rules", {}).items()))
    base = (mesh_cfg if mesh_cfg is not None
            else _mesh_cfg(mesh_name))
    base = dataclasses.replace(base, rules_override=rules_override)

    if shape.kind == "train":
        from repro_torch.core.transparent import TransparentTrainer
        kw = dict(TRAIN_MODES[mode])
        if ov.get("allreduce"):
            kw["allreduce"] = ov["allreduce"]
        run = RunConfig(model=cfg, shape=shape,
                        mesh=dataclasses.replace(base, **kw),
                        optimizer=OptimizerConfig(name="adam"),
                        microbatch=int(ov.get("microbatch", 2)))
        trainer = TransparentTrainer.from_bundle(run, bundle, device="cpu",
                                                 use_kernels=False)
        state = trainer.init(0)
        if "step" in state.opt:
            # Adam reads its step count on the host (the bias corrections
            # in numpy fp32); a constant count carries a value under
            # FakeTensorMode, where a zeros() one has none
            state.opt["step"] = torch.tensor(0, dtype=torch.int32)
        mesh = trainer.mesh
        batch = _local_inputs(bundle.train_input_specs(shape), mesh,
                              mesh.dp_axes, mesh.size(mesh.dp_axes))
        return Cell(cfg, shape, lambda: trainer.step(state, batch),
                    [state.params, state.opt, state.err, batch])

    mesh = (build_mesh(base) if mesh_cfg is not None
            else make_production_mesh(multi_pod=mesh_name == "multi"))
    dp_axes, dp = mesh.dp_axes, dp_size(base)
    rules, sharded = _serve_param_rules(cfg, base)
    axis = sharding.model_axis_for(mesh, sharded)
    gen = torch.Generator().manual_seed(0)
    params = sharding.init_local_params(bundle.specs, rules, mesh, gen,
                                        device="cpu", dtype=torch.bfloat16)
    if shape.kind == "prefill":
        inputs = _local_inputs(bundle.prefill_input_specs(shape), mesh,
                               dp_axes, dp)

        def step():
            with torch.no_grad(), common.model_axis(axis):
                return bundle.prefill_fn(params, **inputs)
        return Cell(cfg, shape, step, [params, inputs])

    # decode: one token on the cell's cache (this rank's slots and heads)
    B = shape.global_batch
    local_b = B // dp if B > 1 and B % dp == 0 else B
    with common.model_axis(axis):
        state = bundle.init_decode_state(local_b, shape.seq_len,
                                         device="cpu")
    tokens = torch.zeros((local_b, 1), dtype=torch.int32)

    def step():
        with torch.no_grad(), common.model_axis(axis):
            return bundle.decode_fn(params, tokens, state)
    return Cell(cfg, shape, step, [params, tokens, state])


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif isinstance(x, torch.Tensor):
        yield x


def run_cell(cell: Cell):
    """Run ``cell.step`` once under an ``OpCounter``; returns (the
    counter, its memory split, the step's seconds, the ATen ops it
    dispatched)."""
    with OpCounter() as c:
        c.track(list(_leaves(cell.arguments)))
        arg_bytes = c.live_now()
        ins = {t.untyped_storage()._cdata for t in _leaves(cell.arguments)}
        c.peak_bytes = arg_bytes
        t0 = time.time()
        out = cell.step()
        step_s = time.time() - t0
        outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _leaves(out)}
    n_ops = sum(int(x.multiplicity) for x in c.stats.contributors)
    out_bytes = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in ins)
    peak = c.peak_bytes
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": peak - arg_bytes - out_bytes + alias,
              "alias_bytes": alias, "peak_estimate_bytes": peak}
    return c, memory, step_s, n_ops


def analyze_cell(arch: str, shape_name: str, mesh_name: str, mode: str,
                 save_hlo: bool = False, overrides: dict = None,
                 rank: int = 0):
    """One production cell in this process: the fake world of the
    production size, this rank's shards, the step on fake tensors.
    Returns (the record, the counter's stats, the cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    world = 512 if mesh_name == "multi" else 256
    t0 = time.time()
    with fake_world(world, rank), FakeTensorMode():
        cell = lower_cell(arch, shape_name, mesh_name, mode, overrides)
        t_lower = time.time() - t0
        c, memory, t_step, n_ops = run_cell(cell)
    stats = c.stats
    cfg, shape = cell.cfg, cell.shape
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name, "mode": mode,
        "devices": world, "rank": rank,
        "lower_s": round(t_lower, 2), "compile_s": round(t_step, 2),
        "memory": memory,
        "xla_cost": {"flops": stats.flops, "bytes_accessed": stats.hbm_bytes},
        "hlo_stats": {
            "dot_flops": stats.dot_flops,
            "conv_flops": stats.conv_flops,
            "fp32_flops": stats.fp32_flops,
            "hbm_bytes": stats.hbm_bytes,
            "wire_bytes": stats.wire_bytes_total,
            "collectives": stats.collective_summary(),
            "wire_bytes_by_group": stats.wire_bytes_by_group(),
            "while_trip_counts": stats.while_trip_counts[:50],
        },
        "model_flops_global": registry.model_flops(cfg, shape),
        "params_total": registry.count_params(cfg),
        "params_active": registry.count_params(cfg, active_only=True),
        "hlo_bytes_len": n_ops,
        "overrides": overrides or {},
    }
    if save_hlo:
        # the eager program's "HLO": every contributor, heaviest first
        lines = [f"{x.flops:.6e} {x.bytes:.6e} x{x.multiplicity:.0f} "
                 f"{x.opcode} {x.shape} {x.comp} {x.meta}"
                 for x in sorted(stats.contributors,
                                 key=lambda x: -(x.flops + x.bytes))]
        import gzip
        with gzip.open(RESULTS_DIR / f"{_cell_id(arch, shape.name, mesh_name, mode)}"
                       ".ops.gz", "wt") as f:
            f.write("\n".join(lines))
    return rec, stats, cell


def _cell_id(arch, shape, mesh, mode, tag=""):
    base = f"{arch}__{shape}__{mesh}__{mode}"
    if tag:
        base += f"__{tag}"
    return base.replace("/", "_")


def run_one(arch, shape, mesh, mode, save_hlo=False, overrides=None, tag=""):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = RESULTS_DIR / f"{_cell_id(arch, shape, mesh, mode, tag)}.json"
    try:
        rec = analyze_cell(arch, shape, mesh, mode, save_hlo, overrides)[0]
        rec["ok"] = True
        if tag:
            rec["tag"] = tag
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "mode": mode,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out.write_text(json.dumps(rec, indent=1))
    status = "OK " if rec.get("ok") else "ERR"
    print(f"[{status}] {out.name}  step={rec.get('compile_s', '-')}s",
          flush=True)
    return rec.get("ok", False)


def parse_overrides(args) -> dict:
    overrides = {}
    if args.microbatch is not None:
        overrides["microbatch"] = args.microbatch
    if args.remat:
        overrides["remat"] = args.remat
    if args.allreduce_override:
        overrides["allreduce"] = args.allreduce_override
    if args.q_block:
        overrides["q_block"] = args.q_block
    if args.kv_block:
        overrides["kv_block"] = args.kv_block
    if args.attn_remat:
        overrides["attn_remat"] = True
    if args.rules:
        overrides["rules"] = {
            k: (v if v not in ("None", "none", "") else None)
            for k, v in (kv.split("=") for kv in args.rules.split(","))}
    return overrides


def add_override_flags(ap):
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"])
    ap.add_argument("--allreduce-override", default=None)
    ap.add_argument("--rules", default=None,
                    help="logical=mesh axis overrides, e.g. "
                         "'vocab_table=model,embed=data'")
    ap.add_argument("--q-block", type=int, default=None)
    ap.add_argument("--kv-block", type=int, default=None)
    ap.add_argument("--attn-remat", action="store_true")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default=None,
                    help="train: paper|zero1|fsdp; serve cells ignore this")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the step's contributors (.ops.gz)")
    ap.add_argument("--subprocess", action="store_true",
                    help="with --all: isolate each cell in a subprocess")
    # hillclimb knobs (single-cell runs)
    ap.add_argument("--tag", default="", help="suffix for the result file")
    add_override_flags(ap)
    args = ap.parse_args()
    overrides = parse_overrides(args)

    if args.list or args.all:
        cells = list(all_cells())
        if args.list:
            for c in cells:
                print("%s %s %s %s" % c)
            print(f"total: {len(cells)} dry-run cells")
            return
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        n_ok = n_err = n_skip = 0
        for (arch, shape, mesh, mode) in cells:
            out = RESULTS_DIR / f"{_cell_id(arch, shape, mesh, mode)}.json"
            if out.exists() and not args.force:
                prev = json.loads(out.read_text())
                if prev.get("ok"):
                    n_skip += 1
                    continue
            if args.subprocess:
                r = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--mode", mode, "--force"]
                    + (["--save-hlo"] if args.save_hlo else []),
                    env={**os.environ, "PYTHONPATH": str(
                        Path(__file__).resolve().parents[2])})
                ok = r.returncode == 0 and json.loads(
                    out.read_text()).get("ok", False)
            else:
                ok = run_one(arch, shape, mesh, mode, args.save_hlo)
            n_ok += int(ok)
            n_err += int(not ok)
        print(f"done: ok={n_ok} err={n_err} skipped={n_skip}")
        return

    assert args.arch and args.shape, "--arch and --shape required (or --all)"
    shape = get_shape(args.shape)
    mode = args.mode or ("paper" if shape.kind == "train" else "serve")
    ok = run_one(args.arch, args.shape, args.mesh, mode, args.save_hlo,
                 overrides=overrides or None, tag=args.tag)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
