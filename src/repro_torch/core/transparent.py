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

One process is one device of ``run_cfg.mesh`` (``launch.mesh``: ranks
linear over the axes, ``model`` innermost; NCCL on the card, gloo on the
CPU); the caller starts the processes and calls ``init_process_group``.
Without a process group the mesh is one device and every collective is
the identity.  Placements come from the sharding rules
(``launch.sharding.param_rules``):

  * ``replicated`` (the paper's): each DP replica holds the parameters
    whole — or, with a ``model`` axis above 1 and a registry bundle
    (``from_bundle``), its tensor-parallel shards, the loss running on
    them under the rank's ``models.common.ModelAxis`` — and the
    strategies of ``core/allreduce.py`` (or the ZeRO-1 ``reduce_scatter``
    strategy: reduce-scatter of the flat fp32 gradient, the optimizer on
    this rank's shard of the flat parameter vector, all-gather) reduce
    over the DP group of the ranks that share this rank's model
    coordinate;
  * ``fsdp``: every leaf with an ``embed`` axis is sharded over the DP
    axes too; inside the loss each layer's leaves are all-gathered as the
    layer loop reaches them (an autograd Function whose backward
    reduce-scatters), as the JAX package streams them inside its layer
    scan, and the optimizer and ``clip_by_global_norm`` run on the shards.

State lives on ``device`` as fp32 masters; the optimizer updates them in
place (see ``repro_torch.optim.optimizers``).  ``canonical_state`` /
``state_structs`` are the rank-independent view a checkpoint stores
(``repro_torch.checkpoint``: whole leaves, gathered), ``load_state`` its
inverse on this rank (re-sharded).
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
from repro_torch.launch import sharding
from repro_torch.launch.mesh import ProcessMesh, build_mesh
from repro_torch.models.common import (logical_to_mesh, manual_axis_specs,
                                       model_axis, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.optim.optimizers import (clip_by_global_norm, global_norm,
                                          make_optimizer)


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


def dp_group_for(mesh_cfg: MeshConfig,
                 mesh: Optional[ProcessMesh] = None) -> ar.DPGroup:
    """The DP replicas of this rank: the ranks that share its model
    coordinate, as a process group of ``mesh`` (built from ``mesh_cfg``
    when not given).  The hierarchical strategy gets this rank's intra-pod
    and cross-pod subgroups."""
    mesh = mesh if mesh is not None else build_mesh(mesh_cfg)
    dp_axes = mesh.dp_axes
    dp = mesh.size(dp_axes)
    if dp == 1:
        return ar.SINGLE
    inner = outer = None
    if mesh_cfg.allreduce == "hierarchical" and "pod" in mesh.axis_names:
        inner, outer = mesh.group(("data",)), mesh.group(("pod",))
    return ar.DPGroup(mesh.group(dp_axes), dp, inner, outer)


class _Gather(torch.autograd.Function):
    """fsdp: all-gather of a leaf's shards along ``dim`` over the DP
    group; backward reduce-scatters (sums the replicas' gradients and
    keeps this rank's block)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.group, ctx.size, ctx.rank = dim, group, size, rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.float().contiguous()
        # gloo has no reduce-scatter on every backend: all-reduce + block
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        n = g.shape[ctx.dim] // ctx.size
        return g.narrow(ctx.dim, ctx.rank * n, n), None, None, None, None


class _LayerStack:
    """fsdp view of a stacked ``[L, ...]`` leaf: indexing layer ``i``
    all-gathers that layer's shards (``_Gather``) — what the model's
    layer loop reaches, one layer at a time.  Supports what the model
    code does with a stacked leaf: ``shape``, ``[i]``, ``to(dtype)`` and
    ``is_floating_point``."""

    def __init__(self, shard, dim: int, dp: ar.DPGroup, rank: int,
                 dtype=None):
        self.shard, self.dim, self.dp, self.rank = shard, dim, dp, rank
        self.dtype = dtype or shard.dtype
        shape = list(shard.shape)
        shape[dim] *= dp.size
        self.shape = torch.Size(shape)

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def to(self, dtype):
        return _LayerStack(self.shard, self.dim, self.dp, self.rank, dtype)

    def __getitem__(self, i: int):
        full = _Gather.apply(self.shard[i], self.dim - 1, self.dp.group,
                             self.dp.size, self.rank)
        return full.to(self.dtype)


# ---------------------------------------------------------------------------
# The transparent primitive: drop-in value_and_grad with injected reduction
# ---------------------------------------------------------------------------

def _value_and_grad(loss_fn, params, *args, view=None, **kw):
    """(loss, fp32 grads) of ``loss_fn(params, ...)`` w.r.t. every leaf.
    The grads are contiguous, as the collectives need: the gradient of a
    leaf used through a permuted view (a conv weight kept HWIO and
    convolved as OIHW) comes back in the view's strides.  ``view`` maps
    the list of leaves to what the loss sees (fsdp's gathered leaves)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        seen = leaves if view is None else view(leaves)
        loss = loss_fn(tree_unflatten(seen, params), *args, **kw)
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
    """Runtime that turns a sequential loss_fn into synchronous training
    over ``run_cfg.mesh``.

    loss_fn(params, batch) -> scalar; param_specs: ParamSpec tree.
    ``model_cfg`` (``from_bundle`` passes the bundle's) lets the rules
    shard over a ``model`` axis: the loss must then be that config's
    registry loss, which carries the collective points.  Without it the
    model axis replicates (each model rank computes the whole model).
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
        return cls(run_cfg, loss_fn, bundle.specs, device=device,
                   model_cfg=bundle.cfg)

    def __init__(self, run_cfg: RunConfig, loss_fn: Callable, param_specs,
                 *, device, model_cfg=None):
        run_cfg.validate()
        mesh_cfg = run_cfg.mesh
        self.run_cfg = run_cfg
        self.mesh_cfg = mesh_cfg
        self.device = torch.device(device)
        self.loss_fn = loss_fn
        self.param_specs = param_specs
        self.opt = make_optimizer(run_cfg.optimizer)
        self.mesh = build_mesh(mesh_cfg)
        self.rules, sharded = sharding.param_rules(mesh_cfg, model_cfg)
        self.model_axis = sharding.model_axis_for(self.mesh, sharded)
        self.placements = logical_to_mesh(param_specs, self.rules)
        self.dp_group = dp_group_for(mesh_cfg, self.mesh)
        self.dp = self.dp_group.size
        # the data-parallel rank: what the data pipeline shards by (the
        # model ranks of one replica feed the same rows)
        self.rank = self.mesh.index(self.mesh.dp_axes)
        self._fsdp = mesh_cfg.dp_mode == "fsdp"
        # per leaf: the dim sharded over the DP axes (fsdp), else None
        dp_specs = manual_axis_specs(param_specs, self.rules,
                                     self.mesh.dp_axes)
        self._dp_dim = [next((d for d, e in enumerate(sp) if e), None)
                        for sp in tree_leaves(dp_specs)]
        self._stacked = [s.axes[:1] == ("layers",)
                         for s in tree_leaves(param_specs)]
        self._zero1 = mesh_cfg.allreduce == "reduce_scatter" \
            and not self._fsdp
        self._n_params = sum(
            int(np.prod(s.shape)) // int(np.prod(
                [self.mesh.size(e) for e in pl]))
            for s, pl in zip(tree_leaves(param_specs),
                             tree_leaves(self.placements)))
        self._padded = -(-self._n_params // self.dp) * self.dp
        # ZeRO-1 on a model axis: the flat vector is this model rank's
        # blocks; the canonical flat leaves stack the model ranks' rows
        self._flat_lead = ((self.model_axis.size,)
                           if self._zero1 and self.model_axis.size > 1
                           else ())
        self._norm_w = None

    # -- init ------------------------------------------------------------------

    def _local_param_shard(self, params) -> torch.Tensor:
        """This rank's slice of the flat fp32 parameter vector."""
        vec = _flatten_to_vec(params)
        vec = torch.nn.functional.pad(vec, (0, self._padded - vec.numel()))
        n = self._padded // self.dp
        return vec[self.rank * n:(self.rank + 1) * n].clone()

    def init(self, seed: int = 0, params=None) -> TrainState:
        """A broadcast-consistent TrainState: this rank's fp32 blocks of
        ``params`` (whole; copied) or of the seeded one-process init, then
        the DP replicas' leaves from their rank 0 (§III-D.1; fsdp shards
        are each rank's own and are not broadcast)."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = sharding.init_local_params(
                self.param_specs, self.rules, self.mesh, gen,
                device=self.device, dtype=torch.float32)
        else:
            params = sharding.local_tree(
                tree_map(lambda p: p.detach().to(self.device, torch.float32),
                         params), self.placements, self.mesh)
        replicated = [l for l, d in zip(tree_leaves(params), self._dp_dim)
                      if d is None]
        bc.broadcast_from_rank0(dict(enumerate(replicated)), self.dp_group)
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
        only; the port's ``ShapeDtypeStruct`` tree): fp32 params at their
        whole shapes, the optimizer state at its global shapes, the
        error-feedback tree under ``compressed`` (else None) and a 0-d
        int32 step.  Under ZeRO-1 the flat optimizer leaves are ``[dp,
        padded / dp]``, the reference's global layout (``[model, dp,
        padded / dp]`` on a model axis: one flat vector a model rank).
        Rank-independent: every rank returns the same."""
        meta = lambda shape: torch.empty(shape, dtype=torch.float32,
                                         device="meta")
        params = tree_map(lambda s: meta(s.shape), self.param_specs)
        flat = self._flat_lead + (self.dp, self._padded // self.dp)
        opt = self.opt.init({"flat": meta(flat)} if self._zero1 else params)
        opt = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), opt)
        err = params if self.mesh_cfg.allreduce == "compressed" else None
        return TrainState(params=params, opt=opt, err=err,
                          step=torch.empty((), dtype=torch.int32,
                                           device="meta"))

    def _param_trees(self, opt):
        """The keys of an optimizer state whose values mirror the params
        (moments, accumulators)."""
        return [k for k, v in opt.items() if isinstance(v, dict)]

    def canonical_state(self, state: TrainState) -> TrainState:
        """``state`` in the layout of ``state_structs``, the same on every
        rank.  A collective on a sharded mesh and under ``reduce_scatter``
        and ``compressed``: every rank calls it.

        * Model- and fsdp-sharded leaves (params, and the optimizer trees
          that mirror them) are all-gathered whole.
        * ZeRO-1: each rank's ``[1, n/dp]`` shard of a flat optimizer leaf
          is all-gathered into ``[dp, n/dp]`` (rank order), and on a model
          axis the model ranks' into ``[model, dp, n/dp]``.
        * ``compressed``: the error-feedback tree differs per rank; the
          view keeps the replicas' mean.  The all-reduce averages the
          compensated gradients ``g_r + e_r``, and ``mean_r(g_r + e) =
          mean_r(g_r + e_r)`` when every rank holds ``e = mean_r(e_r)``, so
          the resumed step reduces the same gradient up to the bf16
          rounding of the wire, which the strategy carries on every step
          anyway (its tolerance against the sequential curve, 3e-2, holds).

        Leaves that are whole on this rank are returned as they lie, not
        copied: save or copy the view before the next step."""
        dp, mesh, pl = self.dp_group, self.mesh, self.placements

        def gather(t):
            if t.ndim != 2:
                return t
            if dp.active:
                out = torch.empty((self.dp, t.shape[1]), dtype=t.dtype,
                                  device=t.device)
                dist.all_gather_into_tensor(out, t.contiguous(),
                                            group=dp.group)
                t = out
            if self._flat_lead:
                parts = [torch.empty_like(t) for _ in range(self._flat_lead[0])]
                dist.all_gather(parts, t.contiguous(),
                                group=self.model_axis.group)
                t = torch.stack(parts)
            return t

        if self._zero1:
            opt = tree_map(gather, state.opt)
        else:
            opt = dict(state.opt)
            for k in self._param_trees(opt):
                opt[k] = sharding.full_tree(opt[k], pl, mesh)
        err = state.err
        if err is not None:
            if dp.active:
                err = tree_map(lambda e: ar.mean_(e.clone(), dp.group,
                                                  dp.size), err)
            err = sharding.full_tree(err, pl, mesh)
        return TrainState(params=sharding.full_tree(state.params, pl, mesh),
                          opt=opt, err=err,
                          step=torch.tensor(int(state.step), dtype=torch.int32))

    def load_state(self, canonical: TrainState) -> TrainState:
        """The inverse of ``canonical_state`` on this rank: a live state on
        the trainer's device (this rank's blocks of every sharded leaf)
        whose ``step`` continues from the canonical one (and with it the
        optimizer's bias corrections).  ZeRO-1 takes this rank's row of
        each ``[dp, n/dp]`` leaf (of its model rank's ``[dp, n/dp]``), so
        the view must be at this trainer's DP degree
        (``checkpoint.elastic.restore_elastic`` re-splits one saved at
        another) and model extent."""
        state = self.init(params=canonical.params)
        src_opt = dict(canonical.opt)
        if not self._zero1:
            for k in self._param_trees(src_opt):
                src_opt[k] = sharding.local_tree(
                    tree_map(lambda t: t.to(self.device), src_opt[k]),
                    self.placements, self.mesh)
        for dst, src in zip(tree_leaves(state.opt), tree_leaves(src_opt)):
            if self._zero1 and src.ndim == 2 + len(self._flat_lead):
                if self._flat_lead:
                    src = src[self.model_axis.rank]
                src = src[self.rank:self.rank + 1]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"optimizer leaf {tuple(src.shape)} does not "
                                 f"fit {tuple(dst.shape)} at dp={self.dp}")
            dst.copy_(src)
        if state.err is not None:
            err = sharding.local_tree(
                tree_map(lambda t: t.to(self.device), canonical.err),
                self.placements, self.mesh)
            for dst, src in zip(tree_leaves(state.err), tree_leaves(err)):
                dst.copy_(src)
        state.step = int(canonical.step)
        return state

    # -- the transparent step ----------------------------------------------------

    def _view(self, leaves):
        """fsdp: what the loss sees of the sharded leaves — a stacked
        layer leaf gathered layer by layer as the loop reaches it, any
        other gathered whole; None without fsdp."""
        dp = self.dp_group
        out = []
        for x, dim, stacked in zip(leaves, self._dp_dim, self._stacked):
            if dim is None:
                out.append(x)
            elif stacked and dim > 0:
                out.append(_LayerStack(x, dim, dp, self.rank))
            else:
                out.append(_Gather.apply(x, dim, dp.group, dp.size,
                                         self.rank))
        return out

    def _grads(self, params, batch):
        view = self._view if self._fsdp and self.dp_group.active else None
        with model_axis(self.model_axis):
            return _value_and_grad(self.loss_fn, params, batch, view=view)

    def _accumulate(self, state: TrainState, batch):
        local_b = next(iter(batch.values())).shape[0]
        n_micro = _num_microbatches(self.run_cfg, local_b)
        if n_micro == 1:
            return self._grads(state.params, batch)
        mb = local_b // n_micro
        acc, loss_acc = None, 0.0
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = self._grads(state.params, micro)
            loss_acc = loss_acc + loss
            if acc is None:
                acc = g
            else:
                for a, b in zip(tree_leaves(acc), tree_leaves(g)):
                    a.add_(b)
        return loss_acc / n_micro, tree_map(lambda g: g.div_(n_micro), acc)

    def _fsdp_reduce(self, grads):
        """fsdp: the sharded leaves' gradients are the replicas' sums (the
        gathers' backward reduce-scattered them) — divide; the replicated
        leaves' are averaged over the DP group."""
        dp = self.dp_group
        if not dp.active:
            return grads
        for g, dim in zip(tree_leaves(grads), self._dp_dim):
            if dim is None:
                ar.mean_(g, dp.group, dp.size)
            else:
                g.div_(dp.size)
        return grads

    def _global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient from this rank's blocks: each
        leaf's sum of squares, summed over the groups its placement
        shards it over (model, DP, both)."""
        sq = torch.zeros(4, dtype=torch.float32, device=self.device)
        for g, pl in zip(tree_leaves(grads), tree_leaves(self.placements)):
            on = {a for e in pl if e for a in ((e,) if isinstance(e, str)
                                               else e)}
            slot = (("model" in on and self.mesh.size("model") > 1)
                    + 2 * bool(on & set(self.mesh.dp_axes)))
            sq[slot] += torch.sum(torch.square(g.float()))
        mg, dg = self.mesh.group(("model",)), self.dp_group.group
        if mg is not None:                 # model-sharded, and both
            part = sq[1::2].clone()
            dist.all_reduce(part, group=mg)
            sq[1::2] = part
        if dg is not None:                 # DP-sharded, and both
            part = sq[2:].clone()
            dist.all_reduce(part, group=dg)
            sq[2:] = part
        return torch.sqrt(sq.sum())

    def _norm_weights(self, like):
        """This rank's segment of the flat vector's norm weights: 1 for a
        model-sharded element, 1 / model for one every model rank holds."""
        if self._norm_w is None:
            m = self.model_axis.size
            w = [torch.full((int(np.prod(s.shape)) // int(np.prod(
                [self.mesh.size(e) for e in pl])),),
                1.0 if "model" in pl else 1.0 / m, device=like.device)
                for s, pl in zip(tree_leaves(self.param_specs),
                                 tree_leaves(self.placements))]
            w = torch.nn.functional.pad(torch.cat(w),
                                        (0, self._padded - self._n_params))
            n = self._padded // self.dp
            self._norm_w = w[self.rank * n:(self.rank + 1) * n].clone()
        return self._norm_w

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
        if self._flat_lead:
            # a leaf whole on every model rank counts once
            sq = torch.sum(self._norm_weights(gshard) * torch.square(gshard)
                           ).reshape(1)
            dist.all_reduce(sq, op=dist.ReduceOp.SUM,
                            group=self.model_axis.group)
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
        """One synchronous step on this rank's local batch (a dict of
        arrays or tensors, moved to the trainer's device; the model ranks
        of one replica get the same rows).  Returns (state, {"loss",
        "grad_norm", "step"}); the state's tensors are updated in place."""
        run_cfg, mesh = self.run_cfg, self.mesh_cfg
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        loss, grads = self._accumulate(state, batch)
        new_err = state.err
        if self._zero1:
            params, opt, gn = self._zero1_update(state, grads)
        else:
            if self._fsdp:
                grads = self._fsdp_reduce(grads)
            else:
                grads, new_err = ar.reduce_gradients(
                    grads, mesh.allreduce, self.dp_group, mesh.bucket_bytes,
                    state.err)
            sharded = self._fsdp or self.model_axis.size > 1
            norm = self._global_norm(grads) if sharded else None
            if run_cfg.optimizer.grad_clip:
                grads, gn = clip_by_global_norm(
                    grads, run_cfg.optimizer.grad_clip, norm=norm)
            else:
                gn = global_norm(grads) if norm is None else norm
            params, opt = self.opt.update(grads, state.opt, state.params)
        new_state = TrainState(params=params, opt=opt, err=new_err,
                               step=state.step + 1)
        return new_state, {"loss": _mean_loss(loss, self.dp_group),
                           "grad_norm": gn, "step": new_state.step}
