"""The user-transparent Session: one object per model.

``load(arch)`` returns a ``Session`` that owns the resolved configs, the
registry bundle, the parameters and the serving engines, and exposes

  * ``session.serve(requests)``     — the continuous-batching engine (paged
                                      pool, prefix cache, chunked prefill,
                                      n-gram speculation);
  * ``session.generate(prompt(s))`` — one-shot generation over the same
                                      engine.

``session.train`` is the trainer slice (ROADMAP queue 1 item 5) and raises
``CapabilityError`` until it is ported.  The device is explicit: ``"cuda"``
by default, raising when CUDA is absent; ``device="cpu"`` runs the port on
the CPU with the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ServeConfig, floor_pow2
from repro_torch.models import registry
from repro_torch.models.common import torch_dtype
from repro_torch.serving.engine import resolve_device

#: auto-sized serve capacity rounds up to this bucket (bounds the engine
#: cache's cardinality under varying prompt lengths)
_SEQ_BUCKET = 64

#: engines kept per Session (oldest evicted; each holds a full KV pool)
_MAX_ENGINES = 4


class CapabilityError(ValueError):
    """A workload the loaded family does not declare (see
    ``ModelBundle.capabilities``), or one the port has not reached yet."""


class Session:
    """One architecture on one device; owns params and engine lifecycles so
    user scripts never touch them directly.  Construct through
    :func:`load`.  Lazy: nothing touches the device until the first
    ``serve`` / ``generate`` call."""

    def __init__(self, model_cfg: ModelConfig, *, seed: int = 0,
                 device=None):
        model_cfg.validate()
        self.model = model_cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.bundle = registry.build(model_cfg)
        self._params = None
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
        """A seeded init on the session's device, made leaf by leaf in the
        compute dtype (shared by every engine of the session)."""
        if self._params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self._params = self.bundle.init_params(
                gen, device=self.device,
                dtype=torch_dtype(self.model.compute_dtype))
        return self._params

    def set_params(self, params) -> None:
        """Replace the parameters (e.g. JAX weights carried across with
        ``repro_torch.convert.from_jax_params``); drops every engine, whose
        prefix caches hold K/V of the old weights."""
        for key in list(self._engines):
            self._drop_engine(key)
        self._params = params

    # -- train -------------------------------------------------------------

    def train(self, *args, **kwargs):
        raise CapabilityError(
            "Session.train is not ported yet — the trainer slice, ROADMAP "
            "queue 1 item 5 (TransparentTrainer, allreduce strategies)")

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
        auto.update(overrides)
        seq = auto.get("max_seq_len", ServeConfig.max_seq_len)
        if "page_size" not in auto:
            # shrink pages for short batches; floor_pow2 keeps the prefix
            # cache's block hashing valid
            cap = floor_pow2(seq)
            layout = self.bundle.kv_layout
            if layout is not None:
                cap = min(cap, layout.max_page_size())
            if ServeConfig.page_size > cap:
                auto["page_size"] = cap
        return ServeConfig(**auto)

    def _drop_engine(self, key) -> None:
        """Retire one cached engine, invalidating its prefix cache first."""
        eng = self._engines.pop(key)
        eng.pool.clear_prefix_cache()
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
            eng = ServingEngine(self.model, serve_cfg, params=self.params,
                                seed=self.seed, device=self.device)
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
        return (f"Session({self.model.name}, device={self.device}, "
                f"capabilities={sorted(self.capabilities())})")


def load(arch: str, *, smoke: bool = False, seed: int = 0, device=None,
         require: Iterable[str] = (), **overrides) -> Session:
    """The one supported entrypoint: ``load(arch) -> Session``.

    ``arch``      any registry architecture of a ported family;
    ``smoke``     the small config variant;
    ``device``    ``"cuda"`` (default; raises without CUDA) or ``"cpu"``;
    ``require``   capability names that must be declared now;
    ``overrides`` ``ModelConfig.replace`` fields (``num_layers=2``, ...).
    """
    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = cfg.replace(**overrides)
    sess = Session(cfg, seed=seed, device=device)
    for cap in require:
        sess._require(cap)
    return sess
