"""User-transparent distributed training — the paper's contribution (its
§III-D) as a PyTorch runtime.

The port of ``src/repro/core/transparent.py``.  The user writes a
sequential loss function (the paper's Fig. 3: the script has no
distribution code).  ``TransparentTrainer`` is the runtime: it injects

  * the Broadcast operator at initialization (§III-D.1, core/broadcast.py),
  * the gradient all-reduce after every batch   (§III-D.2, core/allreduce.py),
  * rank-sharded data ingestion                 (§III-F, repro_torch.data),

exactly where MaTEx-TensorFlow patched the TensorFlow runtime.  Synchronous
data parallelism keeps the losses equal to the sequential run's (§III-E /
Fig. 7; ``tests/test_torch_dp.py``).

Each data-parallel (DP) replica is one process of the default
``torch.distributed`` process group (NCCL on the card, gloo on the CPU);
the caller starts the processes and calls ``init_process_group``.  Without
a process group the trainer is one replica and every collective is the
identity.  Placement is ``replicated`` (the paper's), with the strategies
of ``core/allreduce.py`` or the ZeRO-1 ``reduce_scatter`` strategy:
reduce-scatter of the flat fp32 gradient, the optimizer on this rank's
shard of the flat parameter vector, all-gather.  ``dp_mode="fsdp"`` and a
``model`` axis above 1 raise (ROADMAP queue 1 item 10).

State lives on ``device`` as fp32 masters; the optimizer updates them in
place (see ``repro_torch.optim.optimizers``).  ``canonical_state`` /
``state_structs`` are the rank-independent view a checkpoint stores
(``repro_torch.checkpoint``), ``load_state`` its inverse on this rank.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig, RunConfig
from repro_torch.core import allreduce as ar
from repro_torch.core import broadcast as bc
from repro_torch.models.common import (init_params, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.optim.optimizers import (clip_by_global_norm, global_norm,
                                          make_optimizer)

#: ROADMAP item of the placements this slice does not port
MESH_TODO = ("ROADMAP queue 1 item 10 (mesh placement: fsdp parameter "
             "sharding and tensor parallelism)")


@dataclass
class TrainState:
    params: Any       # fp32 masters (nested dict of tensors)
    opt: Any
    err: Any          # error-feedback tree (compressed strategy) or None
    step: Any         # int on a live state; a 0-d int32 tensor in the
                      # canonical view


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _flatten_to_vec(tree) -> torch.Tensor:
    return torch.cat([l.float().reshape(-1) for l in tree_leaves(tree)])


def _copy_from_vec_(vec, tree):
    """Write consecutive slices of ``vec`` into the leaves of ``tree``."""
    off = 0
    for l in tree_leaves(tree):
        n = l.numel()
        l.copy_(vec[off:off + n].view(l.shape))
        off += n
    return tree


def _num_microbatches(run_cfg: RunConfig, local_batch: int) -> int:
    mb = run_cfg.microbatch
    if mb <= 0 or mb >= local_batch:
        return 1
    if local_batch % mb:
        raise ValueError(f"microbatch {mb} does not divide the local batch "
                         f"{local_batch}")
    return local_batch // mb


def _extent(mesh: MeshConfig, axis: str) -> int:
    return int(np.prod([s for s, a in zip(mesh.shape, mesh.axis_names)
                        if a == axis])) or 1


def dp_group_for(mesh: MeshConfig) -> ar.DPGroup:
    """The DP replicas of ``mesh`` as process groups of the default group.

    Ranks are linear over the DP axes in mesh order (``pod`` outer,
    ``data`` inner).  The hierarchical strategy gets this rank's intra-pod
    and cross-pod subgroups; every rank creates every subgroup, in the same
    order, as ``dist.new_group`` requires."""
    dp = _extent(mesh, "pod") * _extent(mesh, "data")
    if not dist.is_initialized():
        if dp != 1:
            raise ValueError(
                f"mesh {mesh.shape} has {dp} data-parallel replicas: start "
                f"{dp} processes and call torch.distributed."
                "init_process_group in each before building the trainer")
        return ar.SINGLE
    world = dist.get_world_size()
    if world != dp:
        raise ValueError(f"mesh {mesh.shape} has {dp} data-parallel "
                         f"replicas but the process group has {world}")
    inner = outer = None
    pods = _extent(mesh, "pod")
    if mesh.allreduce == "hierarchical" and "pod" in mesh.axis_names:
        per, rank = dp // pods, dist.get_rank()
        for p in range(pods):
            g = dist.new_group([p * per + d for d in range(per)])
            if rank // per == p:
                inner = g
        for d in range(per):
            g = dist.new_group([p * per + d for p in range(pods)])
            if rank % per == d:
                outer = g
    return ar.DPGroup(dist.group.WORLD, world, inner, outer)


# ---------------------------------------------------------------------------
# The transparent primitive: drop-in value_and_grad with injected reduction
# ---------------------------------------------------------------------------

def _value_and_grad(loss_fn, params, *args, **kw):
    """(loss, fp32 grads) of ``loss_fn(params, ...)`` w.r.t. every leaf.
    The grads are contiguous, as the collectives need: the gradient of a
    leaf used through a permuted view (a conv weight kept HWIO and
    convolved as OIHW) comes back in the view's strides."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(leaves, params), *args, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float().contiguous() for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(grads, params)


def _mean_loss(loss, dp: ar.DPGroup):
    if not dp.active:
        return loss
    return ar.mean_(loss.float().reshape(1).clone(), dp.group, dp.size)[0]


def value_and_grad(loss_fn, *, strategy: str = "layerwise",
                   dp: ar.DPGroup = ar.SINGLE, bucket_bytes: int = 32 << 20):
    """``value_and_grad`` drop-in that all-reduces the gradients over the
    DP replicas — the injection the paper performs in the TF runtime, for
    users writing their own loops."""
    def wrapped(params, *args, **kw):
        loss, grads = _value_and_grad(loss_fn, params, *args, **kw)
        grads, _ = ar.reduce_gradients(grads, strategy, dp, bucket_bytes)
        return _mean_loss(loss, dp), grads
    return wrapped


# ---------------------------------------------------------------------------
# TransparentTrainer
# ---------------------------------------------------------------------------

class TransparentTrainer:
    """Runtime that turns a sequential loss_fn into synchronous DP training.

    loss_fn(params, batch) -> scalar; param_specs: ParamSpec tree.
    """

    @classmethod
    def from_bundle(cls, run_cfg: RunConfig, bundle, *, device,
                    use_kernels: Optional[bool] = None):
        """Session-owned construction: a trainer straight from a registry
        ``ModelBundle`` — its ``TrainStepContract`` loss (attention through
        kernel K3 when ``use_kernels``; None = on CUDA only) and ParamSpec
        tree."""
        device = torch.device(device)
        if use_kernels is None:
            use_kernels = device.type == "cuda"
        loss_fn = functools.partial(bundle.loss_fn, use_kernels=use_kernels)
        return cls(run_cfg, loss_fn, bundle.specs, device=device)

    def __init__(self, run_cfg: RunConfig, loss_fn: Callable, param_specs,
                 *, device):
        run_cfg.validate()
        mesh = run_cfg.mesh
        if mesh.dp_mode != "replicated":
            raise NotImplementedError(
                f"dp_mode={mesh.dp_mode!r} is not ported yet — {MESH_TODO}")
        if _extent(mesh, "model") > 1:
            raise NotImplementedError(
                f"a model axis of {_extent(mesh, 'model')} is not ported yet "
                f"— {MESH_TODO}")
        self.run_cfg = run_cfg
        self.mesh_cfg = mesh
        self.device = torch.device(device)
        self.loss_fn = loss_fn
        self.param_specs = param_specs
        self.opt = make_optimizer(run_cfg.optimizer)
        self.dp_group = dp_group_for(mesh)
        self.dp = self.dp_group.size
        self.rank = dist.get_rank() if self.dp_group.active else 0
        self._zero1 = mesh.allreduce == "reduce_scatter"
        self._n_params = sum(int(np.prod(s.shape))
                             for s in tree_leaves(param_specs))
        self._padded = -(-self._n_params // self.dp) * self.dp

    # -- init ------------------------------------------------------------------

    def _local_param_shard(self, params) -> torch.Tensor:
        """This rank's slice of the flat fp32 parameter vector."""
        vec = _flatten_to_vec(params)
        vec = torch.nn.functional.pad(vec, (0, self._padded - vec.numel()))
        n = self._padded // self.dp
        return vec[self.rank * n:(self.rank + 1) * n].clone()

    def init(self, seed: int = 0, params=None) -> TrainState:
        """A broadcast-consistent TrainState: fp32 masters from ``params``
        (copied) or a seeded init on the device, then rank 0's values on
        every replica (§III-D.1)."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.param_specs, gen, device=self.device,
                                 dtype=torch.float32)
        else:
            params = tree_map(lambda p: p.detach().to(
                self.device, torch.float32, copy=True), params)
        bc.broadcast_from_rank0(params, self.dp_group)
        err = (ar.init_error_tree(params)
               if self.mesh_cfg.allreduce == "compressed" else None)
        if self._zero1:
            opt = self.opt.init({"flat": self._local_param_shard(params)[None]})
        else:
            opt = self.opt.init(params)
        return TrainState(params=params, opt=opt, err=err, step=0)

    # -- the canonical state (what a checkpoint holds) -------------------------

    def state_structs(self) -> TrainState:
        """The canonical state's leaves as meta tensors (shape and dtype
        only; the port's ``ShapeDtypeStruct`` tree): fp32 params, the
        optimizer state at its global shapes, the error-feedback tree under
        ``compressed`` (else None) and a 0-d int32 step.  Under ZeRO-1 the
        flat optimizer leaves are ``[dp, padded / dp]``, the reference's
        global layout.  Rank-independent: every rank returns the same."""
        meta = lambda shape: torch.empty(shape, dtype=torch.float32,
                                         device="meta")
        params = tree_map(lambda s: meta(s.shape), self.param_specs)
        opt = self.opt.init({"flat": meta((self.dp, self._padded // self.dp))}
                            if self._zero1 else params)
        opt = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), opt)
        err = params if self.mesh_cfg.allreduce == "compressed" else None
        return TrainState(params=params, opt=opt, err=err,
                          step=torch.empty((), dtype=torch.int32,
                                           device="meta"))

    def canonical_state(self, state: TrainState) -> TrainState:
        """``state`` in the layout of ``state_structs``, the same on every
        rank.  A collective under ``reduce_scatter`` and ``compressed``:
        every rank calls it.

        * ZeRO-1: each rank's ``[1, n/dp]`` shard of a flat optimizer leaf
          is all-gathered into ``[dp, n/dp]`` (rank order).
        * ``compressed``: the error-feedback tree differs per rank; the
          view keeps the replicas' mean.  The all-reduce averages the
          compensated gradients ``g_r + e_r``, and ``mean_r(g_r + e) =
          mean_r(g_r + e_r)`` when every rank holds ``e = mean_r(e_r)``, so
          the resumed step reduces the same gradient up to the bf16
          rounding of the wire, which the strategy carries on every step
          anyway (its tolerance against the sequential curve, 3e-2, holds).

        Parameters (replicated) and everything else are returned as they
        lie, not copied: save or copy the view before the next step."""
        dp = self.dp_group

        def gather(t):
            if not (self._zero1 and dp.active and t.ndim == 2):
                return t
            out = torch.empty((self.dp, t.shape[1]), dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t.contiguous(), group=dp.group)
            return out

        err = state.err
        if err is not None and dp.active:
            err = tree_map(lambda e: ar.mean_(e.clone(), dp.group, dp.size),
                           err)
        return TrainState(params=state.params, opt=tree_map(gather, state.opt),
                          err=err,
                          step=torch.tensor(int(state.step), dtype=torch.int32))

    def load_state(self, canonical: TrainState) -> TrainState:
        """The inverse of ``canonical_state`` on this rank: a live state on
        the trainer's device whose ``step`` continues from the canonical
        one (and with it the optimizer's bias corrections).  ZeRO-1 takes
        this rank's row of each ``[dp, n/dp]`` leaf, so the view must be
        at this trainer's DP degree (``checkpoint.elastic.restore_elastic``
        re-splits one saved at another)."""
        state = self.init(params=canonical.params)
        for dst, src in zip(tree_leaves(state.opt), tree_leaves(canonical.opt)):
            if self._zero1 and src.ndim == 2:
                src = src[self.rank:self.rank + 1]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"optimizer leaf {tuple(src.shape)} does not "
                                 f"fit {tuple(dst.shape)} at dp={self.dp}")
            dst.copy_(src)
        if state.err is not None:
            for dst, src in zip(tree_leaves(state.err),
                                tree_leaves(canonical.err)):
                dst.copy_(src)
        state.step = int(canonical.step)
        return state

    # -- the transparent step ----------------------------------------------------

    def _accumulate(self, state: TrainState, batch):
        local_b = next(iter(batch.values())).shape[0]
        n_micro = _num_microbatches(self.run_cfg, local_b)
        if n_micro == 1:
            return _value_and_grad(self.loss_fn, state.params, batch)
        mb = local_b // n_micro
        acc, loss_acc = None, 0.0
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = _value_and_grad(self.loss_fn, state.params, micro)
            loss_acc = loss_acc + loss
            if acc is None:
                acc = g
            else:
                for a, b in zip(tree_leaves(acc), tree_leaves(g)):
                    a.add_(b)
        return loss_acc / n_micro, tree_map(lambda g: g.div_(n_micro), acc)

    def _zero1_update(self, state: TrainState, grads):
        """ZeRO-1: reduce-scatter(mean) + sharded optimizer + all-gather."""
        dp, clip = self.dp_group, self.run_cfg.optimizer.grad_clip
        n = self._padded // self.dp
        vec = torch.nn.functional.pad(_flatten_to_vec(grads),
                                      (0, self._padded - self._n_params))
        if dp.active:
            gshard = torch.empty(n, dtype=torch.float32, device=vec.device)
            dist.reduce_scatter_tensor(gshard, vec, op=dist.ReduceOp.SUM,
                                       group=dp.group)
            gshard.div_(self.dp)
        else:
            gshard = vec
        sq = torch.sum(torch.square(gshard)).reshape(1)
        if dp.active:
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=dp.group)
        gn = torch.sqrt(sq[0])
        if clip:
            gshard = gshard * torch.clamp(clip / torch.clamp(gn, min=1e-12),
                                          max=1.0)
        pshard = {"flat": self._local_param_shard(state.params)[None]}
        new_pshard, new_opt = self.opt.update({"flat": gshard[None]},
                                              state.opt, pshard)
        if dp.active:
            new_vec = torch.empty(self._padded, dtype=torch.float32,
                                  device=vec.device)
            dist.all_gather_into_tensor(new_vec, new_pshard["flat"][0],
                                        group=dp.group)
        else:
            new_vec = new_pshard["flat"][0]
        _copy_from_vec_(new_vec[:self._n_params], state.params)
        return state.params, new_opt, gn

    def step(self, state: TrainState, batch):
        """One synchronous DP step on this rank's local batch (a dict of
        arrays or tensors, moved to the trainer's device).  Returns (state,
        {"loss", "grad_norm", "step"}); the state's tensors are updated in
        place."""
        run_cfg, mesh = self.run_cfg, self.mesh_cfg
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        loss, grads = self._accumulate(state, batch)
        new_err = state.err
        if self._zero1:
            params, opt, gn = self._zero1_update(state, grads)
        else:
            grads, new_err = ar.reduce_gradients(
                grads, mesh.allreduce, self.dp_group, mesh.bucket_bytes,
                state.err)
            if run_cfg.optimizer.grad_clip:
                grads, gn = clip_by_global_norm(grads,
                                                run_cfg.optimizer.grad_clip)
            else:
                gn = global_norm(grads)
            params, opt = self.opt.update(grads, state.opt, state.params)
        new_state = TrainState(params=params, opt=opt, err=new_err,
                               step=state.step + 1)
        return new_state, {"loss": _mean_loss(loss, self.dp_group),
                           "grad_norm": gn, "step": new_state.step}
