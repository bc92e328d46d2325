"""Pixtral-style VLM backbone: the mistral-nemo decoder and a stub vision
frontend.

The port of ``src/repro/models/pixtral.py``: precomputed patch embeddings
[B, n_img, D] stand in for the pixtral-ViT tower.  They are projected
through a learned adapter and prepended to the token embeddings; the loss
scores the text positions only.  Decode is the dense ``lm_decode``.

``use_kernels`` runs every layer's causal attention over [image ; text]
through kernel K3 (``transformer.layers_forward``): one launch a layer in
prefill, the flash autograd Function in training.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ParamSpec, cast_tree, dot, torch_dtype


def pixtral_specs(cfg):
    d = cfg.d_model
    specs = transformer.lm_specs(cfg)
    specs["adapter"] = {
        "w_in": ParamSpec((d, d), ("embed", "embed2")),
        "b_in": ParamSpec((d,), ("embed2",), init="zeros"),
    }
    return specs


def _prepend_patches(cfg, params, tokens, patches, cd):
    """Embed tokens, adapter-project patches, concatenate [img ; text]."""
    tok_emb = transformer.embed_lookup(cfg, params, tokens, cd)
    img = dot(patches.to(cd), params["adapter"]["w_in"], cd)
    img = img + params["adapter"]["b_in"].to(cd)
    return torch.cat([img, tok_emb], dim=1)


def pixtral_loss(cfg, params, batch, *, use_kernels: bool = False):
    """batch: {"tokens": [B,S_text], "patches": [B,n_img,D], "labels":
    [B,S_text]}"""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    x = _prepend_patches(cfg, params, batch["tokens"], batch["patches"], cd)
    x, _, _ = transformer.layers_forward(cfg, params, x,
                                         use_kernels=use_kernels)
    n_img = batch["patches"].shape[1]
    logits = transformer.lm_head(cfg, params, x[:, n_img:])
    return transformer.cross_entropy(logits, batch["labels"], cfg.vocab_size)


def pixtral_prefill(cfg, params, tokens, patches, *,
                    use_kernels: bool = False):
    """Prefill over [img ; text] -> (last_logits [B,V], stacked ring caches
    of exactly S = n_img + S_text slots: the first decode step overwrites
    position 0, as in the reference)."""
    params = cast_tree(params, cfg.compute_dtype)
    cd = torch_dtype(cfg.compute_dtype)
    x = _prepend_patches(cfg, params, tokens, patches, cd)
    x, caches, _ = transformer.layers_forward(
        cfg, params, x, collect_cache=True, cache_len=x.shape[1],
        use_kernels=use_kernels)
    logits = transformer.lm_head(cfg, params, x[:, -1:])
    return logits[:, 0], caches
