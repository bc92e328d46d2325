"""The port's placements against the JAX package's ``PartitionSpec``s.

Pure functions, no processes: for every architecture's smoke specs on the
meshes 2x2, 4x2, 2x2x2 (pod x data x model) and 16x16, replicated and
fsdp, the port's ``rules_for`` / ``logical_to_mesh`` must give the JAX
package's placement of every parameter leaf, compared as normalised
tuples; so must ``serve_state_pspecs``, ``pool_pspecs`` and
``paged_pspecs`` on the same decode-state structs.

The one expected difference is the port's **whole-head rule**
(``models/common.py:rules_for``): a fused head dim shards over "model"
only on whole heads, so where the head count does not divide the model
axis (or the KV heads neither divide it nor are one) the JAX rules put
"model" on the dim and the port replicates it; and a cache leaf whose KV
heads do not divide the axis replicates where the JAX rules shard its
``head_dim`` instead.  The tests admit exactly those differences, and
check that the rule bites wherever a head count does not divide.
"""
import jax
import numpy as np
import pytest

from repro.configs import ALL_ARCHS, get_config as jax_get_config
from repro.configs.base import MeshConfig as JaxMeshConfig
from repro.launch import sharding as jax_sharding
from repro.models import common as jax_common
from repro.models import registry as jax_registry
from repro.serving import kvcache as jax_kvcache
from repro.serving import layouts as jax_layouts
from repro.serving import paged as jax_paged
from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig
from repro_torch.launch import sharding
from repro_torch.models import common, registry
from repro_torch.serving import kvcache, layouts, paged

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
#: logical axes the whole-head rule may replicate
WHOLE_HEAD = ("heads", "kv_heads")


def _norm(entry):
    """A spec entry as None, an axis name, or a tuple of two or more."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry
    entry = tuple(entry)
    if not entry:
        return None
    return entry[0] if len(entry) == 1 else entry


def _ntuple(spec, ndim):
    out = [_norm(e) for e in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


def _model_size(shape, axes):
    return dict(zip(axes, shape)).get("model", 1)


def _dp(shape, axes):
    dp_axes = tuple(a for a in axes if a in ("pod", "data"))
    return dp_axes, int(np.prod([s for s, a in zip(shape, axes)
                                 if a in dp_axes]))


def _whole_heads(cfg, msize):
    """Which of ``WHOLE_HEAD`` shard under the port's rule."""
    kv = cfg.num_kv_heads
    heads = cfg.num_heads if cfg.rwkv is None \
        else cfg.d_model // cfg.rwkv.head_size
    kv_ok = kv % msize == 0
    heads_ok = heads % msize == 0 and (cfg.rwkv is not None or kv_ok
                                       or kv == 1)
    return {"heads": heads_ok, "kv_heads": kv_ok}


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves_with_paths(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def _jax_by_path(tree):
    """{dict-key path: leaf} of a JAX tree of specs / pspecs / structs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(
            x, (jax_common.ParamSpec, jax.sharding.PartitionSpec)))[0]
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_placements_match_jax(arch, mesh):
    shape, axes = MESHES[mesh]
    msize = _model_size(shape, axes)
    port_cfg, jax_cfg = get_config(arch, smoke=True), \
        jax_get_config(arch, smoke=True)
    port_specs = registry.build(port_cfg).specs
    jax_specs = _jax_by_path(jax_registry.build(jax_cfg).specs)
    whole = _whole_heads(port_cfg, msize)
    n_diff = 0
    for mode in ("replicated", "fsdp"):
        p_rules = common.rules_for(
            MeshConfig(shape=shape, axis_names=axes, dp_mode=mode), port_cfg)
        j_rules = jax_common.rules_for(
            JaxMeshConfig(shape=shape, axis_names=axes, dp_mode=mode),
            jax_cfg)
        got = dict(_leaves_with_paths(common.logical_to_mesh(port_specs,
                                                             p_rules)))
        assert set(got) == set(jax_specs)
        for path, spec in _leaves_with_paths(port_specs):
            want = _ntuple(jax_common.spec_to_pspec(jax_specs[path],
                                                    j_rules), len(spec.shape))
            have = _ntuple(got[path], len(spec.shape))
            for dim, (h, w) in enumerate(zip(have, want)):
                if h == w:
                    continue
                # the whole-head rule, and nothing else
                axis = spec.axes[dim]
                assert (w == "model" and h is None and axis in WHOLE_HEAD
                        and not whole[axis]), (mode, path, dim, h, w)
                n_diff += 1
    # the rule bites exactly where a head count does not divide
    assert (n_diff > 0) == (msize > 1 and not all(whole.values())) \
        or port_cfg.family not in common.TP_FAMILIES


def _state_structs(arch):
    """(port meta tree, JAX struct tree) of a batch-2 decode state."""
    port = registry.build(get_config(arch, smoke=True)).init_decode_state(
        2, 16, device="meta")
    jb = jax_registry.build(jax_get_config(arch, smoke=True))
    return port, jax.eval_shape(lambda: jb.init_decode_state(2, 16))


def _check_cache(got, want_tree, like, name_of_hd_dim):
    """Every leaf's port placement equals the JAX one, except a head_dim
    that the JAX rules shard where the KV heads do not divide (the port
    replicates the leaf)."""
    want = _jax_by_path(want_tree)
    n = 0
    for path, leaf in _leaves_with_paths(like):
        w = _ntuple(want[path], leaf.ndim)
        h = _ntuple(dict(_leaves_with_paths(got))[path], leaf.ndim)
        for dim, (a, b) in enumerate(zip(h, w)):
            if a != b:
                assert (b == "model" and a is None
                        and dim == name_of_hd_dim(path[-1], leaf.ndim)), \
                    (path, dim, a, b)
                n += 1
    return n


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serve_state_pool_and_page_placements_match_jax(arch, mesh):
    shape, axes = MESHES[mesh]
    msize = _model_size(shape, axes)
    dp_axes, dp_total = _dp(shape, axes)
    port, structs = _state_structs(arch)
    kw = dict(dp_axes=dp_axes, dp_total=dp_total, model_size=msize)

    # inputs: the batch over the DP axes when it divides them
    for b in (1, 2, 8):
        ins = {"tokens": _Shape((b, 16)), "pos": _Shape((b,)),
               "n": _Shape(())}
        jins = {k: jax.ShapeDtypeStruct(v.shape, np.int32)
                for k, v in ins.items()}
        got = sharding.serve_input_pspecs(ins, dp_axes=dp_axes,
                                          dp_total=dp_total)
        want = _jax_by_path(jax_sharding.serve_input_pspecs(
            jins, dp_axes=dp_axes, dp_total=dp_total))
        for k, v in ins.items():
            assert _ntuple(got[k], v.ndim) == _ntuple(want[(k,)], v.ndim)

    # decode state [L, B, ...]: the JAX head_dim fallback is dim 4 of k/v,
    # dim 3 of the wkv state
    hd_state = lambda name, nd: {"k": 4, "v": 4, "s": 3}.get(name)
    _check_cache(sharding.serve_state_pspecs(port, **kw),
                 jax_sharding.serve_state_pspecs(structs, **kw), port,
                 hd_state)

    # slot pool [slots, <batch-1 state>]
    slots = 4
    one_p = registry.build(get_config(arch, smoke=True)).init_decode_state(
        1, 16, device="meta")
    jb = jax_registry.build(jax_get_config(arch, smoke=True))
    one_j = jax.eval_shape(lambda: jb.init_decode_state(1, 16))
    pool_p = common.tree_map(
        lambda x: x[None].expand((slots,) + tuple(x.shape)), one_p)
    pool_j = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        (slots,) + x.shape, x.dtype), one_j)
    hd_pool = lambda name, nd: {"k": 5, "v": 5, "s": 4}.get(name)
    _check_cache(kvcache.pool_pspecs(pool_p, **kw),
                 jax_kvcache.pool_pspecs(pool_j, **kw), pool_p, hd_pool)

    # page pools [L, P, ps, ...] of the paged layouts, fp and int8
    cfg = get_config(arch, smoke=True)
    if jb.kv_layout is None or cfg.family not in ("dense", "moe"):
        return
    for kv_dtype in ("fp32", "int8"):
        if kv_dtype == "int8" and cfg.attn_kind == "mla":
            continue
        lay_p = layouts.layout_for(cfg, kv_dtype)
        lay_j = jax_layouts.layout_for(jax_get_config(arch, smoke=True),
                                       kv_dtype)
        blank = {k: v[:, 0] for k, v in one_p.items() if v.ndim > 2}
        pages = {}
        for name in lay_p.data_leaves:
            x = blank[name]                         # [L, ps, ...]
            pages[name] = (x.shape[0], 9) + tuple(x.shape[1:])
            if lay_p.quantized:
                pages[name + layouts.SCALE_SUFFIX] = pages[name][:-1]
        p_structs = {k: _Shape(s) for k, s in pages.items()}
        j_structs = {k: jax.ShapeDtypeStruct(s, np.float32)
                     for k, s in pages.items()}
        got = paged.paged_pspecs(p_structs, model_size=msize, layout=lay_p)
        want = jax_paged.paged_pspecs(j_structs, model_size=msize,
                                      layout=lay_j)
        for name, s in pages.items():
            h, w = _ntuple(got[name], len(s)), _ntuple(want[name], len(s))
            for dim, (a, b) in enumerate(zip(h, w)):
                if a != b:
                    assert b == "model" and a is None and dim == 4 \
                        and name in ("k", "v"), (name, dim, a, b)


def test_with_shardings_gives_local_shapes():
    """``with_shardings``: each leaf's block shape on a mesh (a stand-in
    with 2 data x 4 model ranks; sizes are all it reads)."""
    class Mesh:
        def size(self, entry):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            return int(np.prod([{"data": 2, "model": 4}[a] for a in axes]))

    import torch
    structs = {"k": torch.empty((3, 8, 16, 4, 32), device="meta"),
               "pos": torch.empty((16,), device="meta")}
    specs = {"k": (None, ("data",), None, "model", None), "pos": (None,)}
    out = sharding.with_shardings(structs, specs, Mesh())
    assert tuple(out["k"].shape) == (3, 4, 16, 1, 32)
    assert tuple(out["pos"].shape) == (16,)


class _Shape:
    """A leaf with only a shape (what the placement functions read)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
