"""The port's analytic accounting and spec stand-ins against the JAX
registry's, for every arch at its full config.

``count_params`` / ``embed_param_count`` / ``model_flops`` are exact
integers (and a float product of them): equal, not close.  The input and
state spec functions return meta tensors whose shapes and dtypes must be
the JAX bundles' ``ShapeDtypeStruct`` trees, leaf by leaf (key paths
included); ``param_structs`` likewise.  Nothing is allocated on either
side.
"""
import jax
import numpy as np
import pytest

from repro.configs import ALL_ARCHS, get_config as jax_config
from repro.configs import get_shape as jax_shape
from repro.models import registry as jreg
from repro_torch.configs import get_config, get_shape
from repro_torch.models import registry as preg

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in flat}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}['{k}']"))
        return out
    assert tree.device.type == "meta"
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_counts_and_model_flops_equal_jax(arch):
    jc, pc = jax_config(arch), get_config(arch)
    assert preg.count_params(pc) == jreg.count_params(jc)
    assert preg.count_params(pc, active_only=True) == jreg.count_params(
        jc, active_only=True)
    assert preg.embed_param_count(pc) == jreg.embed_param_count(jc)
    for name in SHAPES:
        assert preg.model_flops(pc, get_shape(name)) == jreg.model_flops(
            jc, jax_shape(name))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_stand_ins_equal_jax(arch):
    jb, pb = jreg.build(jax_config(arch)), preg.build(get_config(arch))
    assert _port_leaves(pb.param_structs()) == _jax_leaves(jb.param_structs())
    for name in SHAPES:
        js, ps = jax_shape(name), get_shape(name)
        if ps.kind == "train":
            pair = jb.train_input_specs(js), pb.train_input_specs(ps)
        elif ps.kind == "prefill":
            pair = jb.prefill_input_specs(js), pb.prefill_input_specs(ps)
        else:
            pair = jb.decode_state_specs(js), pb.decode_state_specs(ps)
        assert _port_leaves(pair[1]) == _jax_leaves(pair[0]), name


def test_decode_state_specs_are_whole_heads_under_a_model_axis():
    """Spec stand-ins are global shapes: a model axis in force (as inside a
    meshed run) does not shrink them."""
    from repro_torch.models.common import ModelAxis, model_axis
    cfg = get_config("qwen2.5-14b")
    b = preg.build(cfg)
    whole = b.decode_state_specs(get_shape("decode_32k"))["k"].shape
    ax = ModelAxis(group=None, size=4, rank=1,
                   sharded=frozenset({"kv_heads", "heads"}))
    with model_axis(ax):
        assert b.decode_state_specs(get_shape("decode_32k"))["k"].shape \
            == whole
