"""Data-parallel ranks of the port's multi-process tests (not a test
module): ``run`` for ``tests/test_torch_dp.py``, ``run_cnn`` for
``tests/test_torch_cnn.py``, ``run_elastic`` and ``run_failed_save`` for
``tests/test_torch_checkpoint.py``, and ``spawn_world``, which starts the
ranks of one of them and collects rank 0's result.

Imports torch and the port only — no jax — so the spawned processes start
quickly.  Rank 0 puts one result on the queue; a rank that fails puts
("error", traceback) instead.
"""
import contextlib
import queue
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.convert import from_jax_params
from repro_torch.core import broadcast as bc
from repro_torch.core.transparent import TransparentTrainer, value_and_grad
from repro_torch.models import cnn, registry
from repro_torch.models.common import init_params, tree_leaves

ARCH = "stablelm-1.6b"
SHAPE = ShapeConfig(name="t", kind="train", seq_len=16, global_batch=8)
#: the JAX trainer tests' bucket size (several buckets on the smoke model)
BUCKET_BYTES = 4096


def _mesh(strategy: str, world: int) -> MeshConfig:
    if strategy == "hierarchical":              # 2 pods x 2 replicas
        return MeshConfig(shape=(2, world // 2, 1),
                          axis_names=("pod", "data", "model"),
                          allreduce=strategy, bucket_bytes=BUCKET_BYTES)
    return MeshConfig(shape=(world, 1), axis_names=("data", "model"),
                      allreduce=strategy, bucket_bytes=BUCKET_BYTES)


def _broadcast_check(bundle, rank: int, world: int):
    """Max replica difference of a per-rank seeded init before and after
    the trainer's init (which broadcasts rank 0's params)."""
    tr = TransparentTrainer(
        RunConfig(model=bundle.cfg, shape=SHAPE, mesh=_mesh("layerwise", world)),
        bundle.loss_fn, bundle.specs, device="cpu")
    raw = init_params(bundle.specs, torch.Generator().manual_seed(rank),
                      dtype=torch.float32)
    before = bc.replicas_identical(raw, tr.dp_group)
    state = tr.init(seed=rank)
    after = bc.replicas_identical(state.params, tr.dp_group)
    rank0 = init_params(bundle.specs, torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    off = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(state.params), tree_leaves(rank0)))
    bc.broadcast_masked(raw, tr.dp_group, rank == 0)
    masked = bc.replicas_identical(raw, tr.dp_group)
    return {"before": before, "after": after, "off_rank0": off,
            "masked": masked}


def _value_and_grad_check(rank: int, world: int):
    """The drop-in ``value_and_grad`` on each rank's slice of a batch
    against the plain gradient of the whole batch: max |difference|."""
    tr = TransparentTrainer(
        RunConfig(model=get_config(ARCH, smoke=True), shape=SHAPE,
                  mesh=_mesh("fused", world)),
        lambda p, b: p, {}, device="cpu")
    gen = torch.Generator().manual_seed(11)
    w = torch.randn((6, 4), generator=gen)
    x = torch.randn((8, 6), generator=gen)

    def loss(p, x):
        return torch.mean((x @ p["w"]) ** 2)

    lb = x.shape[0] // world
    vg = value_and_grad(loss, strategy="fused", dp=tr.dp_group)
    got_loss, got = vg({"w": w}, x[rank * lb:(rank + 1) * lb])
    wr = w.clone().requires_grad_()
    want_loss = loss({"w": wr}, x)
    want = torch.autograd.grad(want_loss, wr)[0]
    return max(float((got["w"] - want).abs().max()),
               abs(float(got_loss) - float(want_loss)))


def run(rank, world, init_file, jobs, np_params, batches, out):
    """Run every job ``name -> (optimizer, strategy)`` for len(batches)
    steps from ``np_params``; each rank trains on its contiguous slice of
    every global batch."""
    with _rank_of(rank, world, init_file, out):
        cfg = get_config(ARCH, smoke=True)
        bundle = registry.build(cfg)
        params = from_jax_params(np_params, dtype=torch.float32)
        results = {"broadcast": _broadcast_check(bundle, rank, world),
                   "value_and_grad": _value_and_grad_check(rank, world)}
        for name, (optimizer, strategy) in jobs.items():
            run_cfg = RunConfig(model=cfg, shape=SHAPE,
                                mesh=_mesh(strategy, world),
                                optimizer=OptimizerConfig(name=optimizer,
                                                          lr=1e-2))
            tr = TransparentTrainer(run_cfg, bundle.loss_fn, bundle.specs,
                                    device="cpu")
            state = tr.init(0, params=params)
            losses = []
            for b in batches:
                state, m = tr.step(state, _local(b, rank, world))
                losses.append(float(m["loss"]))
            results[name] = losses
        if rank == 0:
            out.put(results)


def spawn_world(target, world: int, init_file, args, timeout: float):
    """Start ``world`` spawned processes running ``target(rank, world,
    init_file, *args, out)`` and return what rank 0 puts on ``out``.  Each
    child is joined with a timeout and killed on expiry, so a hang returns
    ("error", ...) instead of eating the suite's time."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, world, str(init_file), *args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        result = out.get(timeout=timeout)
    except queue.Empty:
        result = ("error", f"no result within {timeout} s")
    finally:
        extra = []
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        with contextlib.suppress(queue.Empty):
            while True:
                extra.append(out.get_nowait())
    if isinstance(result, tuple):
        return ("error", result[1] + "".join(
            e[1] for e in extra if isinstance(e, tuple)))
    if not all(not p.is_alive() and p.exitcode == 0 for p in procs):
        return ("error", f"exit codes {[p.exitcode for p in procs]}")
    return result


@contextlib.contextmanager
def _rank_of(rank, world, init_file, out):
    """One gloo rank: the process group around the body, a failure put on
    ``out``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        yield
    except BaseException:
        out.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def _local(batch, rank, world):
    lb = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * lb:(rank + 1) * lb] for k, v in batch.items()}


def run_cnn(rank, world, init_file, np_params, batches, out):
    """The paper's Fig. 7 as published: TinyCNN, momentum lr 1e-2, the
    ``layerwise`` all-reduce; rank 0 puts the loss curve."""
    with _rank_of(rank, world, init_file, out):
        run_cfg = RunConfig(
            model=get_config("tinycnn"), shape=SHAPE,
            mesh=MeshConfig(shape=(world, 1), axis_names=("data", "model"),
                            allreduce="layerwise"),
            optimizer=OptimizerConfig(name="momentum", lr=1e-2))
        tr = TransparentTrainer(
            run_cfg, lambda p, b: cnn.cnn_loss(cnn.tinycnn_forward, p, b, 10),
            cnn.tinycnn_specs(10), device="cpu")
        state = tr.init(0, params=from_jax_params(np_params,
                                                  dtype=torch.float32))
        losses = []
        for b in batches:
            state, m = tr.step(state, _local(b, rank, world))
            losses.append(float(m["loss"]))
        if rank == 0:
            out.put(losses)


def run_elastic(rank, world, init_file, ckpt_dir, np_params, batches, out):
    """ZeRO-1 (``reduce_scatter``) on stablelm smoke, adam lr 1e-2.  With
    no checkpoint in ``ckpt_dir``: train on ``batches`` from
    ``np_params`` and save at the end.  With one: ``restore_elastic`` at
    this world size, then train on ``batches``.  Rank 0 puts {"losses",
    "start" step, "shapes" of this rank's optimizer leaves}."""
    from repro_torch.checkpoint.checkpoint import latest_step, save_checkpoint
    from repro_torch.checkpoint.elastic import restore_elastic
    with _rank_of(rank, world, init_file, out):
        cfg = get_config(ARCH, smoke=True)
        bundle = registry.build(cfg)
        run_cfg = RunConfig(model=cfg, shape=SHAPE,
                            mesh=_mesh("reduce_scatter", world),
                            optimizer=OptimizerConfig(name="adam", lr=1e-2))
        tr = TransparentTrainer(run_cfg, bundle.loss_fn, bundle.specs,
                                device="cpu")
        if latest_step(ckpt_dir) is None:
            state, start = tr.init(0, params=from_jax_params(
                np_params, dtype=torch.float32)), 0
        else:
            state, start = restore_elastic(ckpt_dir, tr)
        shapes = [tuple(t.shape) for t in tree_leaves(state.opt)]
        losses = []
        for b in batches:
            state, m = tr.step(state, _local(b, rank, world))
            losses.append(float(m["loss"]))
        save_checkpoint(ckpt_dir, tr.canonical_state(state), state.step)
        if rank == 0:
            out.put({"losses": losses, "start": start, "shapes": shapes})


def run_failed_save(rank, world, init_file, ckpt_dir, out):
    """Saves that fail on rank 0 must raise on every rank, not leave the
    others waiting for rank 0: a bf16 leaf (its host copy fails; a
    blocking save), then a full disk (``np.save`` raises in an async
    save's write).  A good save then goes through.  Rank 0 puts every
    rank's list: what each failed save raised (on rank 0 the write's own
    error), then the latest step on disk."""
    import errno

    import numpy as np

    from repro_torch.checkpoint.checkpoint import latest_step, save_checkpoint
    with _rank_of(rank, world, init_file, out):
        good = {"w": torch.arange(4.0)}
        bf16 = {"w": torch.zeros(4, dtype=torch.bfloat16)}
        seen = []
        try:
            save_checkpoint(ckpt_dir, bf16 if rank == 0 else good, 1)
            seen.append(None)
        except (TypeError, RuntimeError) as e:
            seen.append(type(e).__name__)

        def full(*args, **kwargs):
            raise OSError(errno.ENOSPC, "No space left on device")
        save = np.save
        if rank == 0:
            np.save = full
        try:
            h = save_checkpoint(ckpt_dir, good, 2, blocking=False)
            h.wait()
            seen.append(None)
        except RuntimeError as e:
            seen.append(type(e.__cause__ or e).__name__)
        finally:
            np.save = save
        save_checkpoint(ckpt_dir, good, 3)
        seen.append(latest_step(ckpt_dir))
        every = [None] * world
        dist.all_gather_object(every, seen)
        if rank == 0:
            out.put(every)
