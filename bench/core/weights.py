"""Weights made from the run's seed, on the device, in the served dtype.

One ``normal_`` call per leaf of the family's parameter tree (leaves are
stacked over layers, so a model is some fifteen large calls), from one
``torch.Generator`` on the device, walked in sorted-key order.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

SEED_MASK = (1 << 63) - 1


def make_weights(shapes, leaf_std: Callable[[Sequence[str], Tuple], float],
                 seed: int, device, dtype=torch.bfloat16):
    """A tree like ``shapes`` (leaves are shape tuples) of tensors drawn
    N(0, leaf_std(path, shape)**2)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(tree[k], path + (k,)) for k in sorted(tree)}
        t = torch.empty(tuple(tree), dtype=dtype, device=device)
        return t.normal_(0.0, leaf_std(path, tree), generator=gen)
    return walk(shapes, ())


def shape_mismatches(shapes, specs, path=()) -> list:
    """Where the benchmark's parameter tree (shape tuples) and the
    program's (objects with ``.shape``) disagree: [] when they match."""
    if isinstance(shapes, dict) or isinstance(specs, dict):
        if not (isinstance(shapes, dict) and isinstance(specs, dict)):
            return ["/".join(path)]
        out = []
        for k in sorted(set(shapes) | set(specs)):
            if k not in shapes or k not in specs:
                out.append("/".join(path + (k,)))
            else:
                out += shape_mismatches(shapes[k], specs[k], path + (k,))
        return out
    return [] if tuple(shapes) == tuple(specs.shape) else [
        f"{'/'.join(path)}: {tuple(shapes)} vs {tuple(specs.shape)}"]
