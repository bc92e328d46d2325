"""The port's MoE feed-forward against the JAX package, on the same weights.

``moe_apply`` in both of its modes — GShard capacity (training) and
``per_token`` drop-free routing (every serving path), each with and without
a masked bucket tail (``n_valid``) — on the deepseek-v2-lite smoke config
(4 experts, top-2, one shared expert) and on a tight-capacity variant where
capacity drops bind.  Weights come from the JAX ``bundle.init_params`` and
are carried across with ``from_jax_params``; everything runs in fp32.
Tolerances: outputs atol 1e-5, the aux loss 1e-6 (the same fp32 math,
another summation order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as jax_moe
from repro.models import registry as jax_registry
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import common as port_common
from repro_torch.models import moe as port_moe
from repro_torch.models import registry as port_registry

ARCH = "deepseek-v2-lite-16b"
#: capacity drops bind: 8 experts, top-2, C = int(24 * 2 / 8 * 0.5) = 3
TIGHT = dict(num_experts=8, top_k=2, capacity_factor=0.5,
             num_shared_experts=0)


def _cfgs(variant):
    cfg = get_config(ARCH, smoke=True)
    pcfg = port_get_config(ARCH, smoke=True)
    if variant == "tight":
        cfg = cfg.replace(moe=cfg.moe.__class__(
            **{**cfg.moe.__dict__, **TIGHT}))
        pcfg = pcfg.replace(moe=pcfg.moe.__class__(
            **{**pcfg.moe.__dict__, **TIGHT}))
    return cfg, pcfg


@functools.lru_cache(maxsize=None)
def _setup(variant):
    cfg, pcfg = _cfgs(variant)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(5))
    ff = jax.tree.map(lambda a: np.asarray(a[0]),
                      params["layers"]["ff"])          # layer 0's experts
    # a router at init is near-uniform; scale it so routing is decisive
    ff["router"] = ff["router"] * 100.0
    return cfg, pcfg, ff


@pytest.mark.parametrize("variant", ["smoke", "tight"])
@pytest.mark.parametrize("per_token", [False, True],
                         ids=["capacity", "per_token"])
@pytest.mark.parametrize("n_valid", [None, 7])
def test_moe_apply_matches_jax(variant, per_token, n_valid):
    cfg, pcfg, ff = _setup(variant)
    x = np.random.default_rng(0).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    jax_fn = jax.jit(functools.partial(jax_moe.moe_apply, cfg,
                                       n_valid=n_valid, per_token=per_token))
    want_y, want_aux = jax_fn(jax.tree.map(jnp.asarray, ff), jnp.asarray(x))
    got_y, got_aux = port_moe.moe_apply(
        pcfg, from_jax_params(ff), torch.from_numpy(x), n_valid=n_valid,
        per_token=per_token)
    rows = slice(None) if n_valid is None else slice(0, n_valid)
    np.testing.assert_allclose(got_y.numpy()[:, rows],
                               np.asarray(want_y)[:, rows], atol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) < 1e-6


def test_capacity_drops_bind_in_the_tight_variant():
    """The tight variant really drops choices in capacity mode, so the two
    modes differ there (the parity above covers a dropping dispatch)."""
    cfg, pcfg, ff = _setup("tight")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32))
    p = from_jax_params(ff)
    cap, _ = port_moe.moe_apply(pcfg, p, x)
    tok, _ = port_moe.moe_apply(pcfg, p, x, per_token=True)
    assert not torch.allclose(cap, tok, atol=1e-3)


def test_per_token_rows_are_independent_and_padding_routes_nowhere():
    """Drop-free routing: a token's output does not depend on the other
    tokens of the call; a padding row (past ``n_valid``) gets the shared
    expert's output only."""
    cfg, pcfg, ff = _setup("smoke")
    p = from_jax_params(ff)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 9, cfg.d_model)).astype(np.float32))
    full, _ = port_moe.moe_apply(pcfg, p, x, per_token=True)
    for i in (0, 4, 8):
        one, _ = port_moe.moe_apply(pcfg, p, x[:, i:i + 1], per_token=True)
        torch.testing.assert_close(one[0, 0], full[0, i], rtol=0, atol=1e-6)
    masked, _ = port_moe.moe_apply(pcfg, p, x, per_token=True, n_valid=5)
    torch.testing.assert_close(masked[:, :5], full[:, :5], rtol=0, atol=1e-6)
    sh = p["shared"]
    shared = port_moe._expert(torch.nn.functional.silu, sh["w_gate"],
                              sh["w_up"], sh["w_down"], x[:, 5:], x.dtype)
    torch.testing.assert_close(masked[:, 5:], shared, rtol=0, atol=1e-6)


def test_from_jax_params_carries_the_moe_mla_tree_key_for_key():
    """The moe family's JAX tree — MLA attention leaves, stacked [L, E, ...]
    expert leaves, nested ``ff.shared.*`` — carries across with the same
    keys, shapes and values, and matches the port's own spec tree."""
    cfg, pcfg = _cfgs("smoke")
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    got = from_jax_params(np_params)
    specs = port_registry.build(pcfg).specs
    flat_j = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(flat_j) == len(port_common.tree_leaves(specs))
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        t, s = got, specs
        for k in keys:
            t, s = t[k], s[k]
        assert tuple(t.shape) == leaf.shape == tuple(s.shape), keys
        np.testing.assert_array_equal(t.numpy(), leaf)
    ff = got["layers"]["ff"]
    assert set(ff) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert ff["w_gate"].shape[:2] == (cfg.num_layers, cfg.moe.num_experts)
    assert set(got["layers"]["attn"]) == {"w_dkv", "kv_norm", "w_uk",
                                          "w_uv", "wo", "wq"}


@pytest.mark.parametrize("smoke", [True, False])
def test_count_params_matches_jax(smoke):
    cfg = get_config(ARCH, smoke=smoke)
    pcfg = port_get_config(ARCH, smoke=smoke)
    for active in (False, True):
        assert port_registry.count_params(pcfg, active_only=active) == \
            jax_registry.count_params(cfg, active_only=active)
    if not smoke:
        assert port_registry.count_params(pcfg) == 16_210_324_992
