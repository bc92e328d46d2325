"""Architecture registry: one uniform interface over the model families.

A ``ModelBundle`` exposes, per architecture, the ParamSpec tree and the
entry points the runtime dispatches on.  Decode-path contracts are typed
(the Protocols below) and ``ModelBundle.capabilities()`` reports which of
them a family declares; the serving engine and ``repro_torch.api``
dispatch on that set, never on ``is None`` probes.

The port builds all six registry families: ``dense`` and ``moe`` (full,
MLA and sliding-window attention, on contiguous, latent or ring pages),
the recurrent ``hybrid`` (recurrentgemma) and ``ssm`` (rwkv6), which have
no ``KVLayout`` and serve on the slotted pool only, and ``encdec``
(whisper) and ``vlm`` (pixtral), which train and declare no serve
contract: their prefill takes per-request frames or patches.  cnn has no
bundle, as in the JAX package, and its error names the way to train it.

The ``*_input_specs`` functions and the ``decode_state_specs`` /
``param_structs`` methods return meta tensors (``device="meta"``: shape and dtype,
no storage) — the port's ``ShapeDtypeStruct`` stand-ins, with the JAX
bundles' shapes and dtypes, for the dry run (``launch/dryrun.py``).
``count_params`` / ``embed_param_count`` / ``model_flops`` are the
analytic accounting the roofline divides by.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import (Any, Callable, FrozenSet, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import (common, pixtral, rglru, rwkv6, transformer,
                                whisper)
from repro_torch.serving.layouts import KVLayout, layout_for


# ---------------------------------------------------------------------------
# Decode-path contracts (typed Protocols; see ModelBundle.capabilities)
# ---------------------------------------------------------------------------

@runtime_checkable
class TrainStepContract(Protocol):
    """Sequential training semantics: ``loss_fn(params, batch, *,
    use_kernels=False) -> scalar`` (``use_kernels`` runs attention through
    kernel K3)."""

    def __call__(self, params, batch, *,
                 use_kernels: bool = False) -> torch.Tensor: ...


@runtime_checkable
class ServeContract(Protocol):
    """Whole-prompt prefill: ``(params, tokens, *, cache_len[, n_valid],
    use_kernels=False) -> (last_logits, state)`` with ``state`` shaped like
    ``init_decode_state(1, cache_len)``; paired with ``decode_fn``.
    ``use_kernels`` is the port's ``use_pallas``: K3 for attention, K9 /
    K10 for the recurrences."""

    def __call__(self, params, tokens, *, cache_len: int,
                 use_kernels: bool = False) -> Tuple[Any, Any]: ...


@runtime_checkable
class PagedServeContract(Protocol):
    """Paged batched decode against the shared page pool:
    ``(params, tokens, state, *, use_kernels=False) -> (logits [slots, V],
    pages)`` with ``state = {"pages": {leaf: [L, P, ps, ...]},
    "page_table": [slots, n] int32, "pos": [slots] int32}``; pages are
    written in place."""

    def __call__(self, params, tokens, state, *,
                 use_kernels: bool = False) -> Tuple[Any, Any]: ...


@runtime_checkable
class PagedPrefillContract(Protocol):
    """Chunked prefill straight into the page pool (the prefix-cache path):
    ``(params, tokens, state, *, use_kernels=False) -> (logits [1, V],
    pages)`` with ``state = {"pages", "page_table": [n] int32, "start":
    int, "n_valid": int}``."""

    def __call__(self, params, tokens, state, *,
                 use_kernels: bool = False) -> Tuple[Any, Any]: ...


@runtime_checkable
class PagedVerifyContract(Protocol):
    """Speculative-decode verify forward: as ``PagedPrefillContract`` but
    the head runs over every position (logits [S, V])."""

    def __call__(self, params, tokens, state, *,
                 use_kernels: bool = False) -> Tuple[Any, Any]: ...


#: capability names a bundle may declare (see ModelBundle.capabilities)
CAPABILITIES = ("train", "serve", "paged_serve", "prefix_serve",
                "spec_serve", "bucketed_prefill")


@dataclass
class ModelBundle:
    cfg: ModelConfig
    specs: Any
    loss_fn: TrainStepContract            # (params, batch, *, use_kernels) -> loss
    prefill_fn: Optional[Callable]        # (params, **inputs, use_kernels) -> (logits, state)
    decode_fn: Optional[Callable]         # (params, tokens, state) -> (logits, state)
    init_decode_state: Callable           # (batch, seq_len, device) -> state
    train_input_specs: Callable           # (ShapeConfig) -> dict of meta tensors
    prefill_input_specs: Callable
    serve_prefill_fn: Optional[ServeContract] = None
    paged_decode_fn: Optional[PagedServeContract] = None
    paged_prefill_fn: Optional[PagedPrefillContract] = None
    paged_verify_fn: Optional[PagedVerifyContract] = None
    kv_layout: Optional[KVLayout] = None
    # True when serve_prefill_fn accepts ``n_valid`` (masked bucket tail).
    # Recurrent families advance their state token by token, so tail
    # padding would corrupt it; ring-caching families would wrap padding
    # onto valid slots — both keep exact-length slotted prefills
    masked_prefill: bool = False

    def capabilities(self) -> FrozenSet[str]:
        """Declared decode-path contracts (subset of ``CAPABILITIES``)."""
        caps = set()
        if self.loss_fn is not None:
            caps.add("train")
        if self.serve_prefill_fn is not None and self.decode_fn is not None:
            caps.add("serve")
            if self.masked_prefill:
                caps.add("bucketed_prefill")
        if self.paged_decode_fn is not None:
            caps.add("paged_serve")
            if self.paged_prefill_fn is not None:
                caps.add("prefix_serve")
            if self.paged_verify_fn is not None:
                caps.add("spec_serve")
        return frozenset(caps)

    def decode_state_specs(self, shape: ShapeConfig):
        """The decode state of ``shape`` as meta tensors: the family's own
        ``init_decode_state`` on the meta device, at whole heads (outside
        any model axis)."""
        with common.model_axis(None):
            return self.init_decode_state(shape.global_batch, shape.seq_len,
                                          device="meta")

    def param_structs(self):
        """The ParamSpec tree as meta tensors (each leaf's shape and
        dtype)."""
        return common.tree_map(
            lambda s: _meta(s.shape, common.torch_dtype(s.dtype)), self.specs)

    def init_params(self, gen: torch.Generator, *, device="cpu", dtype=None):
        """Seeded init from ``gen`` (a generator on ``device``); ``dtype``
        casts each leaf as it is made (see ``common.init_params``)."""
        return common.init_params(self.specs, gen, device=device,
                                  dtype=dtype)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _lm_train_specs(shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32)}


def _lm_prefill_specs(shape: ShapeConfig):
    return {"tokens": _meta((shape.global_batch, shape.seq_len),
                            torch.int32)}


# ---------------------------------------------------------------------------
# Family builders
# ---------------------------------------------------------------------------

def _build_lm(cfg: ModelConfig) -> ModelBundle:
    # the layout seam decides paged capability — never an attn_kind probe
    layout = layout_for(cfg)
    return ModelBundle(
        cfg=cfg,
        specs=transformer.lm_specs(cfg),
        loss_fn=functools.partial(transformer.lm_loss, cfg),
        prefill_fn=lambda params, tokens, *, use_kernels=False:
            transformer.lm_prefill(
                cfg, params, tokens,
                cache_len=transformer.decode_cache_len(cfg, tokens.shape[1]),
                use_kernels=use_kernels),
        decode_fn=functools.partial(transformer.lm_decode, cfg),
        init_decode_state=lambda b, s, device="cpu":
            transformer.init_decode_caches(cfg, b, s, device=device),
        train_input_specs=_lm_train_specs,
        prefill_input_specs=_lm_prefill_specs,
        # serving prefill routes MoE drop-free per token (moe_dropless)
        serve_prefill_fn=lambda params, tokens, *, cache_len, n_valid=None,
        use_kernels=False: transformer.lm_prefill(
            cfg, params, tokens,
            cache_len=transformer.decode_cache_len(cfg, cache_len),
            n_valid=n_valid, use_kernels=use_kernels, moe_dropless=True),
        paged_decode_fn=(functools.partial(transformer.lm_paged_decode, cfg)
                         if layout is not None else None),
        paged_prefill_fn=(functools.partial(transformer.lm_paged_prefill,
                                            cfg)
                          if layout is not None else None),
        paged_verify_fn=(functools.partial(transformer.lm_paged_verify, cfg)
                         if layout is not None else None),
        kv_layout=layout,
        masked_prefill=(layout is not None and not layout.ring),
    )


def _build_rg(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        specs=rglru.rg_specs(cfg),
        loss_fn=functools.partial(rglru.rg_loss, cfg),
        prefill_fn=lambda params, tokens, *, use_kernels=False:
            rglru.rg_prefill(cfg, params, tokens, use_kernels=use_kernels),
        decode_fn=functools.partial(rglru.rg_decode, cfg),
        init_decode_state=lambda b, s, device="cpu":
            rglru.rg_init_states(cfg, b, s, device=device),
        train_input_specs=_lm_train_specs,
        prefill_input_specs=_lm_prefill_specs,
        serve_prefill_fn=lambda params, tokens, *, cache_len,
        use_kernels=False: rglru.rg_prefill(
            cfg, params, tokens, cache_len=cache_len,
            use_kernels=use_kernels),
    )


def _build_rwkv(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        specs=rwkv6.rwkv_specs(cfg),
        loss_fn=functools.partial(rwkv6.rwkv_loss, cfg),
        prefill_fn=lambda params, tokens, *, use_kernels=False:
            rwkv6.rwkv_prefill(cfg, params, tokens, use_kernels=use_kernels),
        decode_fn=functools.partial(rwkv6.rwkv_decode, cfg),
        init_decode_state=lambda b, s, device="cpu":
            rwkv6.rwkv_init_states(cfg, b, device=device),
        train_input_specs=_lm_train_specs,
        prefill_input_specs=_lm_prefill_specs,
        # recurrent state is O(1) in sequence length: capacity is a no-op
        serve_prefill_fn=lambda params, tokens, *, cache_len,
        use_kernels=False: rwkv6.rwkv_prefill(cfg, params, tokens,
                                              use_kernels=use_kernels),
    )


def _build_whisper(cfg: ModelConfig) -> ModelBundle:
    e = cfg.encdec
    cd = common.torch_dtype(cfg.compute_dtype)

    def init_state(b, s, device="cpu"):
        return {"self": transformer.init_decode_caches(cfg, b, s,
                                                       device=device),
                "enc": torch.zeros((b, e.encoder_seq_len, cfg.d_model),
                                   dtype=cd, device=device)}

    def train_specs(shape: ShapeConfig):
        B, S = shape.global_batch, shape.seq_len
        return {"frames": _meta((B, e.encoder_seq_len, cfg.d_model), cd),
                **_lm_train_specs(shape)}

    def prefill_specs(shape: ShapeConfig):
        s = train_specs(shape)
        return {"frames": s["frames"], "tokens": s["tokens"]}

    return ModelBundle(
        cfg=cfg,
        specs=whisper.whisper_specs(cfg),
        loss_fn=functools.partial(whisper.whisper_loss, cfg),
        prefill_fn=lambda params, frames, tokens, *, use_kernels=False:
            whisper.whisper_prefill(cfg, params, frames, tokens,
                                    use_kernels=use_kernels),
        decode_fn=functools.partial(whisper.whisper_decode, cfg),
        init_decode_state=init_state,
        train_input_specs=train_specs,
        prefill_input_specs=prefill_specs,
    )


def _build_pixtral(cfg: ModelConfig) -> ModelBundle:
    n_img = cfg.vlm.num_image_tokens
    cd = common.torch_dtype(cfg.compute_dtype)

    def train_specs(shape: ShapeConfig):
        B, S = shape.global_batch, shape.seq_len
        s_text = max(S - n_img, 1)
        return {"tokens": _meta((B, s_text), torch.int32),
                "patches": _meta((B, n_img, cfg.d_model), cd),
                "labels": _meta((B, s_text), torch.int32)}

    def prefill_specs(shape: ShapeConfig):
        s = train_specs(shape)
        return {"tokens": s["tokens"], "patches": s["patches"]}

    return ModelBundle(
        cfg=cfg,
        specs=pixtral.pixtral_specs(cfg),
        loss_fn=functools.partial(pixtral.pixtral_loss, cfg),
        prefill_fn=lambda params, tokens, patches, *, use_kernels=False:
            pixtral.pixtral_prefill(cfg, params, tokens, patches,
                                    use_kernels=use_kernels),
        decode_fn=functools.partial(transformer.lm_decode, cfg),
        init_decode_state=lambda b, s, device="cpu":
            transformer.init_decode_caches(cfg, b, s, device=device),
        train_input_specs=train_specs,
        prefill_input_specs=prefill_specs,
    )


#: the JAX registry has no CNN bundle either
_CNN = ("family cnn (alexnet, tinycnn) has no registry bundle: train it "
        "with repro_torch.models.cnn (cnn_loss over alexnet_forward or "
        "tinycnn_forward, with alexnet_specs / tinycnn_specs) through "
        "repro_torch.core.transparent.TransparentTrainer")

_BUILDERS = {"dense": _build_lm, "moe": _build_lm, "hybrid": _build_rg,
             "ssm": _build_rwkv, "encdec": _build_whisper,
             "vlm": _build_pixtral}


def build(cfg: ModelConfig) -> ModelBundle:
    cfg.validate()
    if cfg.family == "cnn":
        raise NotImplementedError(_CNN)
    return _BUILDERS[cfg.family](cfg)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (total, incl. embeddings); ``active_only``
    leaves out the experts a token does not run (every MoE layer's held
    experts but ``top_k``)."""
    bundle = build(cfg)
    total = sum(int(np.prod(leaf.shape))
                for leaf in common.tree_leaves(bundle.specs))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert       # gate + up + down
        total -= (max(m.held - m.top_k, 0) * per_expert
                  * (cfg.num_layers - cfg.first_dense_layers))
    return total


def embed_param_count(cfg: ModelConfig) -> int:
    n = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        n *= 2
    return n


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step: 6·N·T (train), 2·N·T (prefill), 2·N·B (decode),
    with N = active params excluding the input embedding table (lm_head
    kept)."""
    n_active = count_params(cfg, active_only=True)
    n_active -= cfg.vocab_size * cfg.d_model          # input table is a gather
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch        # decode: 1 new token/seq
