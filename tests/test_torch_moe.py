"""The port's MoE feed-forward against the JAX package, on the same weights.

``moe_apply`` in both of its modes — GShard capacity (training) and
``per_token`` drop-free routing (every serving path), each with and without
a masked bucket tail (``n_valid``) — on the deepseek-v2-lite smoke config
(4 experts, top-2, one shared expert) and on a tight-capacity variant where
capacity drops bind.  The sorted route's grouped GEMM (its plain version
over the tile table, ``kernels/moe_grouped``) also on a skewed variant: 8
routed experts, top-2, one expert taking most tokens, so its group
straddles a 64-row tile; at verify widths (1-5 tokens, experts with no
picks), with a bucket tail, and over expert-parallel slices.  Weights
come from the JAX ``bundle.init_params`` and are carried across with
``from_jax_params``; everything runs in fp32.
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
from repro_torch.kernels.moe_grouped import kernel as moe_kernel
from repro_torch.kernels.moe_grouped import ref as moe_ref
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


#: routed experts only, 8 of them, top-2; ``_skew_setup`` points expert 0's
#: router column along a direction every input leans on
SKEW = dict(num_experts=8, top_k=2, capacity_factor=0.5,
            num_shared_experts=0)


@functools.lru_cache(maxsize=None)
def _skew_setup():
    cfg = get_config(ARCH, smoke=True)
    pcfg = port_get_config(ARCH, smoke=True)
    cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, **SKEW}))
    pcfg = pcfg.replace(moe=pcfg.moe.__class__(
        **{**pcfg.moe.__dict__, **SKEW}))
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(5))
    ff = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["ff"])
    lean = np.random.default_rng(3).normal(size=cfg.d_model)
    lean = (lean / np.linalg.norm(lean)).astype(np.float32)
    ff["router"] = ff["router"] * 10.0
    ff["router"][:, 0] += 1.5 * lean
    return cfg, pcfg, ff, lean


def _skew_x(S, d_model, lean):
    rng = np.random.default_rng(S)
    return (rng.normal(size=(1, S, d_model)) + 2.0 * lean).astype(np.float32)


def _picks_per_expert(pcfg, p, x):
    _, _, sel = port_moe._route(p["router"], x.reshape(-1, x.shape[-1]),
                                pcfg.moe.top_k)
    return torch.bincount(sel.reshape(-1), minlength=pcfg.moe.num_experts)


@pytest.mark.parametrize("S,n_valid", [(1, None), (2, None), (3, None),
                                       (4, None), (5, None), (5, 3),
                                       (80, None), (80, 61)])
def test_sorted_route_matches_jax_per_token(S, n_valid):
    """The sorted route (the grouped GEMM's plain version over the tile
    table) against the JAX package's per-token dispatch: verify widths of
    1-5 tokens, where experts have no picks; 80 tokens, where expert 0's
    group straddles a 64-row tile; each with and without a bucket tail."""
    cfg, pcfg, ff, lean = _skew_setup()
    x = _skew_x(S, cfg.d_model, lean)
    p = from_jax_params(ff)
    counts = _picks_per_expert(pcfg, p, torch.from_numpy(x))
    if S <= 5:
        assert int(counts.min()) == 0
    else:
        assert 64 < int(counts[0]) <= 128       # two tiles of 64 rows
    want_y, want_aux = jax.jit(functools.partial(
        jax_moe.moe_apply, cfg, n_valid=n_valid, per_token=True))(
        jax.tree.map(jnp.asarray, ff), jnp.asarray(x))
    got_y, got_aux = port_moe.moe_apply(pcfg, p, torch.from_numpy(x),
                                        n_valid=n_valid, per_token=True)
    rows = slice(None) if n_valid is None else slice(0, n_valid)
    np.testing.assert_allclose(got_y.numpy()[:, rows],
                               np.asarray(want_y)[:, rows], atol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) < 1e-6


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sorted_route_expert_slices_sum_to_jax(n_ranks):
    """Expert parallelism: each rank's grouped GEMM over its own experts
    (``first`` > 0 on every rank but the first) gives a partial sum; the
    partials add up to the JAX package's per-token output."""
    cfg, pcfg, ff, lean = _skew_setup()
    x = _skew_x(80, cfg.d_model, lean)
    want, _ = jax.jit(functools.partial(jax_moe.moe_apply, cfg,
                                        per_token=True))(
        jax.tree.map(jnp.asarray, ff), jnp.asarray(x))
    p = from_jax_params(ff)
    xf = torch.from_numpy(x[0])
    _, gates, sel = port_moe._route(p["router"], xf, pcfg.moe.top_k)
    n_local = pcfg.moe.num_experts // n_ranks
    got = sum(moe_kernel.moe_grouped(
        xf, *(p[w][r * n_local:(r + 1) * n_local]
              for w in ("w_gate", "w_up", "w_down")),
        sel.reshape(-1), gates, first=r * n_local, act=pcfg.act)
        for r in range(n_ranks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], atol=1e-5)


def test_sorted_route_tile_table_at_the_skewed_group():
    """The table the route builds for 80 skewed tokens: expert 0's picks
    in two tiles (64 + the rest), every other expert's in one, the empty
    slots last, within ``tile_bound``."""
    cfg, pcfg, ff, lean = _skew_setup()
    p = from_jax_params(ff)
    x = torch.from_numpy(_skew_x(80, cfg.d_model, lean)[0])
    _, _, sel = port_moe._route(p["router"], x, pcfg.moe.top_k)
    counts = torch.bincount(sel.reshape(-1), minlength=8)
    order, tiles = moe_ref.group_picks(sel.reshape(-1), 0, 8)
    assert moe_ref.TILE_ROWS == 64
    assert tiles.shape[0] == moe_ref.tile_bound(160, 8)
    want = []
    lo = 0
    for e, c in enumerate(counts.tolist()):
        want += [[e, r, min(r + 64, lo + c)] for r in range(lo, lo + c, 64)]
        lo += c
    live = tiles[:, 2] > tiles[:, 1]
    assert tiles[live].tolist() == want
    assert not live[len(want):].any() and len(want) == 1 + int(
        (counts > 0).sum())


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
