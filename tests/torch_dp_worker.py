"""One data-parallel rank of ``tests/test_torch_dp.py`` (not a test module).

Imports torch and the port only — no jax — so the spawned processes start
quickly.  Rank 0 puts one result dict on the queue; a rank that fails puts
("error", traceback) instead.
"""
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.convert import from_jax_params
from repro_torch.core import broadcast as bc
from repro_torch.core.transparent import TransparentTrainer, value_and_grad
from repro_torch.models import registry
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
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        cfg = get_config(ARCH, smoke=True)
        bundle = registry.build(cfg)
        params = from_jax_params(np_params, dtype=torch.float32)
        results = {"broadcast": _broadcast_check(bundle, rank, world),
                   "value_and_grad": _value_and_grad_check(rank, world)}
        lb = SHAPE.global_batch // world
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
                local = {k: v[rank * lb:(rank + 1) * lb] for k, v in b.items()}
                state, m = tr.step(state, local)
                losses.append(float(m["loss"]))
            results[name] = losses
        if rank == 0:
            out.put(results)
    except BaseException:
        out.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()
