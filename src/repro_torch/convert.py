"""Carry the JAX package's parameters across to the port.

``from_jax_params(np_tree)`` takes the reference parameter pytree as
numpy arrays (``jax.tree.map(np.asarray, params)`` — the caller converts,
so this module never imports jax) and returns the port's nested dict of
tensors, key for key.  The two packages share the layout of every leaf,
so no leaf is transposed:

  * linear weights stay ``[in, out]`` (``x @ w``; the port's ``dot`` is a
    plain ``torch.matmul``, not ``nn.Linear``'s ``[out, in]``);
  * stacked layer leaves stay ``[L, ...]`` (the JAX package scanned over
    them; the port loops over their slices);
  * the embedding table stays ``[vocab, d_model]`` and ``lm_head``
    ``[d_model, vocab]``;
  * norm scales stay as stored (rms_norm applies ``1 + scale``).

The JAX package's init draws from threefry, which PyTorch cannot
reproduce, so parity tests always build weights with the JAX
``bundle.init_params`` and carry them across with this function.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(np_tree, *, device="cpu", dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (floating leaves cast to ``dtype`` when given)."""
    if isinstance(np_tree, dict):
        return {k: from_jax_params(v, device=device, dtype=dtype)
                for k, v in np_tree.items()}
    arr = np.asarray(np_tree)
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
