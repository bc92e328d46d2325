"""The user-transparent Session: one object per model.

``load(arch)`` returns a ``Session`` that owns the resolved configs, the
registry bundle, the parameters, the trainer and the serving engines, and
exposes

  * ``session.train(steps=...)``    — the paper's user-transparent
                                      trainer: broadcast init, gradient
                                      all-reduce, rank-sharded data (data
                                      parallel over the processes of the
                                      default ``torch.distributed`` group),
                                      async checkpoints and elastic
                                      resume;
  * ``session.serve(requests)``     — the continuous-batching engine (paged
                                      pool, prefix cache, chunked prefill,
                                      n-gram speculation; the slotted pool
                                      for the recurrent families and
                                      ``kv_layout="slotted"``);
  * ``session.generate(prompt(s))`` — one-shot generation over the same
                                      engine.

The device is explicit: ``"cuda"`` by default, raising when CUDA is
absent; ``device="cpu"`` runs the port on the CPU with the kernels' plain
PyTorch versions.

``mesh=`` (``"DxM"`` / ``"PxDxM"`` / a shape / a ``MeshConfig``) is the
only distribution knob a user script needs: the caller starts one
process per mesh device and calls ``torch.distributed.init_process_group``
in each, and the same script then trains and serves over the mesh
(``launch.mesh``: tensor parallelism over "model", data parallelism over
"data" / "pod").
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, ModelConfig,
                                      OptimizerConfig, RunConfig,
                                      ServeConfig, ShapeConfig, floor_pow2)
from repro_torch.models import registry
from repro_torch.models.common import tree_map, torch_dtype
from repro_torch.serving.engine import resolve_device

MeshLike = Union[None, str, Tuple[int, ...], MeshConfig]

#: axis names by mesh rank: "4" -> 4x1 data x model, "4x2" -> data x model,
#: "2x4x2" -> pod x data x model (the paper's two-pod layout)
_AXES_BY_RANK = {2: ("data", "model"), 3: ("pod", "data", "model")}

#: auto-sized serve capacity rounds up to this bucket (bounds the engine
#: cache's cardinality under varying prompt lengths)
_SEQ_BUCKET = 64

#: engines kept per Session (oldest evicted; each holds a full KV pool)
_MAX_ENGINES = 4


class CapabilityError(ValueError):
    """A workload the loaded family does not declare (see
    ``ModelBundle.capabilities``), or one the port has not reached yet."""


def parse_mesh(spec: MeshLike) -> Optional[MeshConfig]:
    """``"2x2"`` / ``(2, 2)`` / ``MeshConfig`` / ``None`` -> ``MeshConfig``.

    Strings are ``D``, ``DxM`` or ``PxDxM`` (data / model / pod extents);
    this is the single parser behind ``--mesh`` in every launcher and the
    ``mesh=`` argument of ``repro_torch.api.load``.
    """
    if spec is None or spec == "":
        return None
    if isinstance(spec, MeshConfig):
        spec.validate()
        return spec
    if isinstance(spec, str):
        try:
            shape = tuple(int(x) for x in spec.lower().split("x"))
        except ValueError:
            raise ValueError(
                f"mesh spec {spec!r} is not of the form 'D', 'DxM' or "
                "'PxDxM' (e.g. '2x2' = 2-way data x 2-way model)") from None
    else:
        shape = tuple(int(x) for x in spec)
    if len(shape) == 1:
        # pure DP (the paper's setting): a 2-D mesh with a size-1 model
        # axis — the sharding rules always name "model"
        shape = shape + (1,)
    axes = _AXES_BY_RANK.get(len(shape))
    if axes is None or any(s < 1 for s in shape):
        raise ValueError(
            f"mesh shape {shape} must be 1-3 positive extents "
            "(data | data x model | pod x data x model)")
    return MeshConfig(shape=shape, axis_names=axes)


@dataclass
class TrainResult:
    """What ``Session.train`` hands back: the per-step loss trajectory plus
    the last step's metrics, the straggler-monitor summary and the
    checkpoint saves it made (``SaveHandle``: step, bytes, copy and write
    seconds)."""
    losses: List[float]
    metrics: Dict[str, float]
    step: int
    elapsed_s: float
    straggler: Dict[str, float] = field(default_factory=dict)
    saves: List[Any] = field(default_factory=list)

    @property
    def loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


class Session:
    """One architecture on one device; owns params, trainer and engine
    lifecycles so user scripts never touch them directly.  Construct
    through :func:`load`.  Lazy: nothing touches the device until the
    first ``train`` / ``serve`` / ``generate`` call."""

    def __init__(self, model_cfg: ModelConfig,
                 mesh_cfg: Optional[MeshConfig] = None, *, seed: int = 0,
                 device=None, dp_mode: Optional[str] = None,
                 allreduce: Optional[str] = None):
        model_cfg.validate()
        self.model = model_cfg
        self.mesh_cfg = mesh_cfg
        self._mesh = None
        self.seed = seed
        self.device = resolve_device(device)
        self.bundle = registry.build(model_cfg)
        self._mesh_overrides = {k: v for k, v in
                                (("dp_mode", dp_mode), ("allreduce", allreduce))
                                if v is not None}
        self._params = None
        self._init_params = None       # set_params: where training starts
        self._trainer = None
        self._trainer_key = None
        self._train_state = None
        self._stream = None            # (iterator, prefetcher) kept across
        self._stream_key = None        # train() calls: data must not replay
        self._engines: Dict[ServeConfig, Any] = {}
        self._last_engine = None

    # -- capabilities ------------------------------------------------------

    def capabilities(self) -> frozenset:
        """Declared decode-path contracts of the loaded family."""
        return self.bundle.capabilities()

    def _require(self, cap: str):
        if cap not in self.capabilities():
            raise CapabilityError(
                f"{self.model.name} ({self.model.family}) doesn't {cap} yet: "
                f"declared capabilities are {sorted(self.capabilities())} — "
                "see ModelBundle.capabilities / ROADMAP.md")

    # -- params lifecycle --------------------------------------------------

    @property
    def params(self):
        """The parameters serving uses, in the compute dtype: a copy of
        the trained masters once ``train`` has run, else those given to
        ``set_params``, else a seeded init on the session's device made
        leaf by leaf (shared by every engine of the session)."""
        if self._params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self._params = self.bundle.init_params(
                gen, device=self.device,
                dtype=torch_dtype(self.model.compute_dtype))
        return self._params

    def set_params(self, params) -> None:
        """Replace the parameters (e.g. JAX weights carried across with
        ``repro_torch.convert.from_jax_params``): serving uses them, and
        the next ``train`` starts from them (as fp32 masters) instead of
        continuing a trained state.  Drops every engine, whose prefix
        caches hold K/V of the old weights."""
        for key in list(self._engines):
            self._drop_engine(key)
        self._params = params
        self._init_params = params
        self._train_state = None

    # -- train -------------------------------------------------------------

    def _train_mesh_cfg(self) -> MeshConfig:
        """The session's mesh; without one, one data-parallel replica per
        process of the default process group (one without a group)."""
        base = self.mesh_cfg
        if base is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            base = MeshConfig(shape=(world, 1), axis_names=("data", "model"))
        return dataclasses.replace(base, **self._mesh_overrides) \
            if self._mesh_overrides else base

    @property
    def mesh(self):
        """The process mesh (``launch.mesh.ProcessMesh``, built on first
        use; None when meshless)."""
        if self.mesh_cfg is None:
            return None
        if self._mesh is None:
            from repro_torch.launch.mesh import build_mesh
            self._mesh = build_mesh(self._train_mesh_cfg())
        return self._mesh

    def train(self, steps: int = 50, *, data=None, seq_len: int = 64,
              global_batch: int = 8,
              optimizer: Optional[OptimizerConfig] = None,
              lr: Optional[float] = None, microbatch: int = 0,
              use_kernels: Optional[bool] = None, ckpt_dir: str = "",
              ckpt_every: int = 25, resume: bool = False,
              log_every: int = 0) -> TrainResult:
        """Run ``steps`` training steps of the sequential ``loss_fn``; the
        runtime injects broadcast init, gradient all-reduce and rank-sharded
        data (the paper's §III-D/F).  Data-parallel when the caller has
        started one process per replica and called
        ``torch.distributed.init_process_group`` in each.

        ``data`` is a ``repro_torch.data.readers.DataSet`` — this rank's
        shard (default: synthetic tokens seeded from the session seed).
        ``use_kernels`` runs attention through kernel K3's autograd
        Function (None: on CUDA only); the recurrences (RG-LRU, WKV) train
        through their differentiable plain versions, as the reference's
        loss does.  Repeated calls with the same knobs continue from the
        current state and the next batches of the stream: ``train(N)`` then
        ``train(N)`` equals ``train(2N)``.  Masters and optimizer state are
        fp32; afterwards serving gets a compute-dtype copy of the trained
        parameters.

        ``ckpt_dir``: an async checkpoint every ``ckpt_every`` steps and a
        durable one at the end (``repro_torch.checkpoint``).  ``resume``
        with a checkpoint there restores the latest one through
        ``restore_elastic`` (any DP degree) and continues its step count;
        the data stream starts anew, as the reference's does.
        """
        self._require("train")
        from repro_torch.checkpoint.checkpoint import (latest_step,
                                                       save_checkpoint)
        from repro_torch.checkpoint.elastic import restore_elastic
        from repro_torch.checkpoint.failures import StragglerMonitor
        from repro_torch.core.transparent import TransparentTrainer
        from repro_torch.data.pipeline import make_input_pipeline
        from repro_torch.data.readers import synthetic_tokens

        opt = optimizer or OptimizerConfig(
            name="adam", lr=1e-3 if lr is None else lr)
        if optimizer is not None and lr is not None:
            opt = dataclasses.replace(opt, lr=lr)
        mesh_cfg = self._train_mesh_cfg()
        key = (seq_len, global_batch, opt, microbatch, mesh_cfg, use_kernels)
        if self._trainer is not None and self._trainer_key != key \
                and self._train_state is not None:
            warnings.warn(
                "train() knobs changed (shape/optimizer/mesh/kernels): the "
                "trained state is discarded and training restarts from a "
                "fresh init; pass the same knobs to continue a run",
                stacklevel=2)
        if self._trainer is None or self._trainer_key != key:
            run = RunConfig(
                model=self.model,
                shape=ShapeConfig("api", "train", seq_len, global_batch),
                mesh=mesh_cfg, optimizer=opt, seed=self.seed,
                microbatch=microbatch)
            self._trainer = TransparentTrainer.from_bundle(
                run, self.bundle, device=self.device, use_kernels=use_kernels)
            self._trainer_key = key
            self._train_state = None
        trainer = self._trainer

        # the data stream persists across train() calls: a continuation
        # consumes the *next* batches, never a replay of already-seen ones
        stream_key = (key, None if data is None else id(data))
        if self._stream is None or self._stream_key != stream_key:
            if self._stream is not None:
                self._stream[1].close()
            if data is None:
                data = synthetic_tokens(
                    self.model.vocab_size, seq_len,
                    num_samples=global_batch * 64, seed=self.seed,
                    rank=trainer.rank, world=trainer.dp)
            self._stream = make_input_pipeline(
                data, global_batch, self.device, world=trainer.dp,
                seed=self.seed)
            self._stream_key = stream_key
        it, _ = self._stream

        if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
            self._train_state, _ = restore_elastic(ckpt_dir, trainer)
        elif self._train_state is None:
            self._train_state = trainer.init(self.seed,
                                             params=self._init_params)
        state = self._train_state
        start = state.step
        monitor = StragglerMonitor()

        losses: List[float] = []
        saves: List[Any] = []
        t_start = time.time()
        step = start
        m = None
        try:
            for batch in it:
                t0 = time.time()
                state, m = trainer.step(state, batch)
                losses.append(float(m["loss"]))        # waits for the step
                monitor.record(time.time() - t0)
                step = int(m["step"])
                if log_every and (step % log_every == 0 or step == start + 1):
                    print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                          f"gnorm {float(m['grad_norm']):.3f}", flush=True)
                if ckpt_dir and ckpt_every and step % ckpt_every == 0:
                    if saves:
                        saves[-1].wait()       # one save in flight at a time
                    saves.append(save_checkpoint(
                        ckpt_dir, trainer.canonical_state(state), step,
                        blocking=False))
                if step >= start + steps:
                    break
        except BaseException:
            # stream state is unknown mid-batch: drop it so the next call
            # starts a fresh pipeline (the prefetch thread is daemon)
            self._stream[1].close()
            self._stream = None
            raise
        if saves:
            saves[-1].wait()
        if ckpt_dir and not (saves and saves[-1].step == step):
            saves.append(save_checkpoint(
                ckpt_dir, trainer.canonical_state(state), step,
                blocking=True))
        self._train_state = state
        # serving must see the new params: drop the engines and hand them
        # a compute-dtype copy (their per-call cast stays a no-op) — whole
        # (gathered on a sharded mesh: each engine keeps its block)
        for k in list(self._engines):
            self._drop_engine(k)
        cd = torch_dtype(self.model.compute_dtype)
        from repro_torch.launch.sharding import full_tree
        params = full_tree(state.params, trainer.placements, trainer.mesh)
        self._params = tree_map(lambda p: p.detach().to(cd, copy=True),
                                params)
        metrics = {"loss": losses[-1] if losses else float("nan"),
                   "grad_norm": float(m["grad_norm"]) if losses else 0.0,
                   "step": step}
        return TrainResult(losses=losses, metrics=metrics, step=step,
                           elapsed_s=time.time() - t_start,
                           straggler=monitor.summary(), saves=saves)

    # -- serve / generate --------------------------------------------------

    def _serve_cfg(self, prompts: Sequence[Sequence[int]],
                   max_new: Optional[int],
                   overrides: Dict[str, Any]) -> ServeConfig:
        """Resolve a ServeConfig: explicit knobs win, the rest auto-sizes to
        the submitted batch (longest prompt + generation budget)."""
        auto: Dict[str, Any] = {}
        if prompts:
            longest = max(len(p) for p in prompts)
            budget = max_new if max_new is not None else \
                overrides.get("max_new_tokens", 32)
            auto["max_batch"] = min(
                8, 1 << max(len(prompts) - 1, 0).bit_length())
            need = longest + budget
            auto["max_seq_len"] = -(-need // _SEQ_BUCKET) * _SEQ_BUCKET
        if max_new is not None:
            auto["max_new_tokens"] = max_new
        layout = self.bundle.kv_layout
        if layout is not None and layout.ring_window:
            # what a two-kind pool has no form of yet stays off unless
            # asked for (the engine then names what is missing)
            auto.update(enable_prefix_cache=False, enable_spec=False)
        auto.update(overrides)
        seq = auto.get("max_seq_len", ServeConfig.max_seq_len)
        if "page_size" not in auto:
            # shrink pages for short batches; floor_pow2 keeps the prefix
            # cache's block hashing valid
            cap = floor_pow2(seq)
            if layout is not None:
                cap = min(cap, layout.max_page_size())
            if ServeConfig.page_size > cap:
                auto["page_size"] = cap
        return ServeConfig(**auto)

    def _drop_engine(self, key) -> None:
        """Retire one cached engine, invalidating its prefix cache first and
        releasing its decode graphs (their private memory pool)."""
        eng = self._engines.pop(key)
        eng.pool.clear_prefix_cache()
        eng.close()
        if self._last_engine is eng:
            self._last_engine = None

    def _engine_for(self, serve_cfg: ServeConfig):
        from repro_torch.serving.engine import ServingEngine
        for key in [k for k, e in self._engines.items()
                    if k.kv_layout != serve_cfg.kv_layout
                    or k.kv_dtype != serve_cfg.kv_dtype
                    or e.model_cfg.attn_kind != self.model.attn_kind]:
            self._drop_engine(key)
        eng = self._engines.pop(serve_cfg, None)
        if eng is None:
            # on a mesh each engine draws its own blocks of the seeded init
            # (the same values) unless there are weights to cut
            params = self.params if self.mesh_cfg is None else self._params
            eng = ServingEngine(self.model, serve_cfg, params=params,
                                mesh_cfg=self.mesh_cfg, seed=self.seed,
                                device=self.device)
        self._engines[serve_cfg] = eng          # re-insert = LRU touch
        while len(self._engines) > _MAX_ENGINES:
            self._drop_engine(next(iter(self._engines)))
        self._last_engine = eng
        return eng

    @property
    def engine(self):
        """The most recently used serving engine (metrics live here)."""
        return self._last_engine

    @property
    def tracer(self):
        """The last-used engine's tracer (None before any serve call)."""
        return None if self._last_engine is None else self._last_engine.tracer

    def save_trace(self, path: str) -> Optional[str]:
        """Write the last serve's Chrome trace JSON; None when no engine has
        run or the last serve was untraced."""
        if self._last_engine is None:
            return None
        return self._last_engine.save_trace(path)

    def serve(self, requests: Sequence[Sequence[int]], *,
              max_new: Optional[int] = None, stream=None,
              serve_cfg: Optional[ServeConfig] = None,
              sampling=None, **serve_overrides) -> List[List[int]]:
        """Continuous-batching generation for a closed batch of prompts
        (lists of token ids); returns one token list per prompt, in order.
        Pass a full ``serve_cfg`` or individual ``ServeConfig`` field
        overrides as keyword arguments (``use_kernels=False``,
        ``prefill_chunk_tokens=256``, ...).  ``sampling`` is one
        ``SamplingParams`` for every prompt or a per-prompt list."""
        self._require("serve")
        prompts = [list(map(int, p)) for p in requests]
        if serve_cfg is not None:
            cfg = serve_cfg.replace(**serve_overrides) if serve_overrides \
                else serve_cfg
        else:
            cfg = self._serve_cfg(prompts, max_new, serve_overrides)
        eng = self._engine_for(cfg)
        return eng.generate(prompts, max_new, stream=stream,
                            sampling=sampling)

    def generate(self, prompts, max_new: int = 16, *, stream=None,
                 sampling=None, **serve_overrides):
        """One-shot convenience over :meth:`serve`: accepts one prompt (flat
        token sequence -> returns one token list) or a batch of prompts."""
        self._require("serve")
        seq = list(prompts)
        single = bool(seq) and all(isinstance(t, (int, np.integer))
                                   for t in seq)
        batch = [seq] if single else seq
        outs = self.serve(batch, max_new=max_new, stream=stream,
                          sampling=sampling, **serve_overrides)
        return outs[0] if single else outs

    def __repr__(self):
        mesh = "x".join(map(str, self.mesh_cfg.shape)) if self.mesh_cfg \
            else "single-device"
        return (f"Session({self.model.name}, mesh={mesh}, "
                f"device={self.device}, "
                f"capabilities={sorted(self.capabilities())})")


def load(arch: str, *, smoke: bool = False, mesh: MeshLike = None,
         seed: int = 0, device=None, dp_mode: Optional[str] = None,
         allreduce: Optional[str] = None, require: Iterable[str] = (),
         **overrides) -> Session:
    """The one supported entrypoint: ``load(arch) -> Session``.

    ``arch``      any registry architecture of a ported family;
    ``smoke``     the small config variant;
    ``mesh``      ``"DxM"`` string / shape tuple / ``MeshConfig`` / None —
                  the only distribution knob a user script needs (one
                  process per mesh device, each in the default process
                  group);
    ``device``    ``"cuda"`` (default; raises without CUDA) or ``"cpu"``;
    ``dp_mode`` / ``allreduce``  training placement / gradient-reduction
                  strategy (``MeshConfig`` fields);
    ``require``   capability names that must be declared now;
    ``overrides`` ``ModelConfig.replace`` fields (``num_layers=2``, ...).
    """
    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = cfg.replace(**overrides)
    sess = Session(cfg, parse_mesh(mesh), seed=seed, device=device,
                   dp_mode=dp_mode, allreduce=allreduce)
    for cap in require:
        sess._require(cap)
    return sess
