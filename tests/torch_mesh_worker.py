"""Mesh ranks of the port's multi-process mesh tests (not a test module):
``run_serve`` for ``tests/test_torch_mesh_serving.py``, ``run_train`` for
``tests/test_torch_mesh_train.py``, ``run_dryrun_cells`` for
``tests/test_torch_dryrun.py``.  Started through
``torch_dp_worker.spawn_world`` (gloo, ``init_method="file://..."``); every
rank runs every job in the same order, and rank 0 puts the results on the
queue together with whether every rank saw the same ones.

Imports torch and the port only — no jax — so the spawned processes start
quickly.
"""
import numpy as np
import torch
import torch.distributed as dist

from torch_dp_worker import _rank_of
from repro_torch import api
from repro_torch.checkpoint.checkpoint import save_checkpoint
from repro_torch.checkpoint.elastic import restore_elastic
from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ServeConfig, ShapeConfig)
from repro_torch.convert import from_jax_params
from repro_torch.core.transparent import TransparentTrainer
from repro_torch.data.pipeline import make_input_pipeline
from repro_torch.data.readers import synthetic_tokens
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.serving.engine import ServingEngine

MESH_2X2 = MeshConfig(shape=(2, 2), axis_names=("data", "model"))
SHAPE = ShapeConfig(name="t", kind="train", seq_len=16, global_batch=8)
ADAM = {"name": "adam", "lr": 1e-2}


def _agree(result):
    """(result, every rank's equal to it)."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, result)
    return all(r == result for r in every)


def run_serve(rank, world, init_file, cases, session_case, out):
    """Serve every case ``name -> (arch, np_params, batches, knobs)`` on a
    2x2 mesh: one engine a case, its batches in turn (later batches see
    the earlier ones' prefix cache).  Returns per case the streams and the
    engine's prefix-hit, draft, accept and preemption counts; then
    ``Session.serve(mesh="2x2")`` beside the raw engine with the same
    ``mesh_cfg`` on ``session_case``."""
    with _rank_of(rank, world, init_file, out):
        results = {}
        for name, (arch, np_params, batches, knobs) in cases.items():
            eng = ServingEngine(get_config(arch, smoke=True),
                                ServeConfig(**knobs),
                                params=from_jax_params(np_params),
                                mesh_cfg=MESH_2X2, device="cpu")
            streams = [eng.generate(b, knobs["max_new_tokens"])
                       for b in batches]
            m = eng.metrics
            results[name] = (streams, {
                "prefix_hit_tokens": m.prefix_hit_tokens,
                "drafted_tokens": m.drafted_tokens,
                "accepted_tokens": m.accepted_tokens,
                "preemptions": m.preemptions,
                "local_slots": getattr(eng.pool, "local_slots", None)})
        arch, np_params, prompts, knobs = session_case
        sess = api.load(arch, smoke=True, device="cpu", mesh="2x2")
        sess.set_params(from_jax_params(np_params))
        got = sess.serve(prompts, serve_cfg=ServeConfig(**knobs))
        raw = ServingEngine(sess.model, ServeConfig(**knobs),
                            params=from_jax_params(np_params),
                            mesh_cfg=MESH_2X2, device="cpu")
        results["session"] = (got, raw.generate(prompts,
                                                knobs["max_new_tokens"]))
        agree = _agree({k: v[0] for k, v in results.items()})
        if rank == 0:
            out.put({"results": results, "agree": agree})


def _local(batch, rank: int, dp: int):
    n = next(iter(batch.values())).shape[0] // dp
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _trainer(arch, mesh_cfg, opt=None):
    cfg = get_config(arch, smoke=True)
    run = RunConfig(model=cfg, shape=SHAPE, mesh=mesh_cfg,
                    optimizer=OptimizerConfig(**(opt or ADAM)))
    return TransparentTrainer.from_bundle(run, registry.build(cfg),
                                          device="cpu")


def _steps(tr, state, batches):
    losses, norms = [], []
    for b in batches:
        state, m = tr.step(state, _local(b, tr.rank, tr.dp))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def run_train(rank, world, init_file, jobs, steps, weights, batches, ckpt,
              session_arch, out):
    """Every job ``name -> (arch, MeshConfig, optimizer kwargs)`` (its
    device count the world) from ``weights[arch]`` over ``steps`` of
    ``batches[arch]``, each rank on its
    data-parallel slice; then the checkpoint jobs of ``ckpt`` (``name ->
    (arch, MeshConfig, dir, steps)``):

    * ``"save"``: train that many steps and checkpoint the canonical state;
    * ``"resume"``: ``restore_elastic`` the checkpoint onto this mesh,
      train that many steps on and save again;

    then, with ``session_arch``, ``Session.train(mesh="2x2")`` beside
    ``from_bundle`` on the Session's data."""
    with _rank_of(rank, world, init_file, out):
        results = {}
        for name, (arch, mesh_cfg, opt) in jobs.items():
            tr = _trainer(arch, mesh_cfg, opt)
            params = from_jax_params(weights[arch], dtype=torch.float32)
            state, losses, norms = _steps(tr, tr.init(0, params=params),
                                          batches[arch][:steps])
            # the canonical view and back: this rank's state, exactly
            again = tr.load_state(tr.canonical_state(state))
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(state.params) + tree_leaves(state.opt),
                tree_leaves(again.params) + tree_leaves(again.opt)))
            results[name] = (losses, norms, same)
        for name, (arch, mesh_cfg, d, n) in ckpt.items():
            tr = _trainer(arch, mesh_cfg)
            if name == "save":
                params = from_jax_params(weights[arch], dtype=torch.float32)
                state, start = tr.init(0, params=params), 0
            else:
                state, start = restore_elastic(d, tr)
            state, losses, _ = _steps(tr, state,
                                      batches[arch][start:start + n])
            save_checkpoint(d, tr.canonical_state(state), start + n,
                            blocking=True)
            results[name] = (start, losses)
        if session_arch:
            results["session"] = _session_vs_trainer(session_arch)
        agree = _agree(results)
        if rank == 0:
            out.put({"results": results, "agree": agree})


def _session_vs_trainer(arch, steps: int = 3, seq_len: int = 16,
                        batch: int = 8):
    """``Session.train(mesh="2x2")`` and the hand-wired trainer on the same
    mesh, configs and data pipeline: (session losses, trainer losses)."""
    cfg = get_config(arch, smoke=True)
    ds = synthetic_tokens(cfg.vocab_size, seq_len, num_samples=batch * 8)
    sess = api.load(arch, smoke=True, device="cpu", mesh="2x2")
    res = sess.train(steps=steps, data=ds, seq_len=seq_len,
                     global_batch=batch)
    run = RunConfig(model=cfg, shape=ShapeConfig("ref", "train", seq_len,
                                                 batch),
                    mesh=MESH_2X2, optimizer=OptimizerConfig(name="adam",
                                                             lr=1e-3))
    tr = TransparentTrainer.from_bundle(run, registry.build(cfg),
                                        device="cpu")
    state = tr.init(0)
    it, pf = make_input_pipeline(ds, batch, "cpu", world=tr.dp)
    ref = []
    for _, b in zip(range(steps), it):
        state, m = tr.step(state, b)
        ref.append(float(m["loss"]))
    pf.close()
    return res.losses, ref


def collective_key(stats):
    """A counter's collectives as a sorted, comparable list: (kind,
    per-device buffer bytes, group size, count, issuing function)."""
    return sorted((c.kind, c.result_bytes, c.group_size, c.multiplicity,
                   c.site) for c in stats.collectives)


def run_dryrun_cells(rank, world, init_file, cells, out):
    """The dry run's cells for real: each ``name -> (arch, ShapeConfig,
    mode)`` built by ``launch.dryrun.lower_cell`` on the 2x2 mesh (smoke
    config) and run once on real tensors under the op counter; rank 0
    puts every rank's counted collectives, in rank order."""
    from repro_torch.launch import dryrun
    with _rank_of(rank, world, init_file, out):
        mine = {}
        for name, (arch, shape, mode) in cells.items():
            cell = dryrun.lower_cell(arch, shape, "single", mode,
                                     cfg=get_config(arch, smoke=True),
                                     mesh_cfg=MESH_2X2)
            counter = dryrun.run_cell(cell)[0]
            mine[name] = collective_key(counter.stats)
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            out.put({"ranks": every})
