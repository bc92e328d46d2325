"""The port's RecurrentGemma (RG-LRU + local attention) against the JAX
package, on the same weights and inputs.

Inputs are made with numpy from a seed; weights come from the JAX
``bundle.init_params`` and are carried across with ``from_jax_params``.
Where the JAX function reaches a Pallas kernel (``use_pallas=True``: the
RG-LRU scan K9 and the flash-attention kernel K3), it runs in interpret
mode, as the JAX package's own kernel tests run it on the CPU; the port's
``use_kernels=True`` runs the kernels' plain versions here (CPU tensors).

Tolerances: K9's plain version against ``lru_scan_ref`` and the Pallas
kernel 1e-5 (the same sequential fp32 recurrence; exp may differ in the
last ulp); the associative scan against JAX's 1e-5 (the same odd/even
recursion); the smoke model's logits and prefill states 1e-4 (fp32
through 5 layers, summation order differs); conv and integer cache
bookkeeping exact or 1e-6; greedy tokens identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.rglru_scan import ops as jax_lru_ops
from repro.kernels.rglru_scan.ref import lru_scan_ref as jax_lru_ref
from repro.models import registry as jax_registry
from repro.models import rglru as jr
from repro.models.transformer import lm_head as jax_lm_head
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.rglru_scan import kernel as port_kernel
from repro_torch.kernels.rglru_scan import ops as port_ops
from repro_torch.models import registry as port_registry
from repro_torch.models import rglru as pr
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import lm_head as port_lm_head

ARCH = "recurrentgemma-2b"

#: the (B, S, W, block_t, dtype) grid of tests/test_kernels.py
LRU_CASES = [
    (2, 64, 32, 16, "float32"),
    (1, 100, 129, 32, "float32"),    # ragged S and W
    (3, 16, 64, 8, "float32"),
    (2, 48, 64, 16, "bfloat16"),
]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return x.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config(ARCH, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(7))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, port_get_config(ARCH, smoke=True), np_params


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's ``use_pallas`` paths with the Pallas kernels in
    interpret mode (no TPU here)."""
    monkeypatch.setattr(jax_lru_ops, "lru_scan", functools.partial(
        jax_lru_ops.lru_scan, interpret=True))
    monkeypatch.setattr(jax_fa_ops, "flash_attention", functools.partial(
        jax_fa_ops.flash_attention, interpret=True))


@pytest.mark.parametrize("B,S,W,bt,dtype", LRU_CASES)
def test_lru_scan_plain_matches_jax(B, S, W, bt, dtype):
    """K9's plain version (through the kernel wrapper, which takes it for
    CPU tensors, and through ``use_kernel=False``) equals the JAX oracle
    and the Pallas kernel in interpret mode; no launch is counted."""
    rng = np.random.default_rng(S * 100 + W)
    la = -np.abs(rng.normal(size=(B, S, W))).astype(np.float32)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    jla, jx = jnp.asarray(la, JNP[dtype]), jnp.asarray(x, JNP[dtype])
    want = np.asarray(jax_lru_ref(jla.astype(jnp.float32),
                                  jx.astype(jnp.float32)))
    pallas = np.asarray(jax_lru_ops.lru_scan(jla, jx, interpret=True,
                                             block_t=bt))
    tla = torch.from_numpy(la).to(TORCH[dtype])
    tx = torch.from_numpy(x).to(TORCH[dtype])
    before = port_kernel.lru_scan_kernel.launches
    for use_kernel in (True, False):
        got = _np(port_ops.lru_scan(tla, tx, use_kernel=use_kernel))
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, pallas, atol=1e-5)
    assert port_kernel.lru_scan_kernel.launches == before


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("kernels", [False, True], ids=["scan", "kernel"])
def test_rg_lru_scan_matches_jax(with_h0, kernels, jax_interpret):
    """``rg_lru_scan`` (gates + recurrence, with the ``h0`` virtual step)
    against the JAX function: the associative scan against the JAX
    associative scan, and the kernel path (K9's plain version) against
    the JAX ``use_pallas`` path (the Pallas kernel in interpret mode)."""
    cfg = get_config(ARCH, smoke=True)
    p = jax.tree.map(np.asarray, jax_registry.build(cfg).init_params(
        jax.random.PRNGKey(3))["blocks"]["rec1"])
    p = jax.tree.map(lambda a: a[0], p)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, 64)).astype(np.float32) if with_h0 else None
    jy, jh = jr.rg_lru_scan(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            None if h0 is None else jnp.asarray(h0),
                            use_pallas=kernels)
    ty, th = pr.rg_lru_scan(from_jax_params(p), torch.from_numpy(x),
                            None if h0 is None else torch.from_numpy(h0),
                            use_kernels=kernels)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-5)


def test_causal_conv1d_with_state():
    cfg = get_config(ARCH, smoke=True)
    p = jax.tree.map(np.asarray, jax_registry.build(cfg).init_params(
        jax.random.PRNGKey(5))["tail"])
    p = jax.tree.map(lambda a: a[0], p)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    state = rng.normal(size=(2, 3, 64)).astype(np.float32)
    for st in (None, state):
        jy, js = jr.causal_conv1d(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x),
                                  None if st is None else jnp.asarray(st))
        ty, ts = pr.causal_conv1d(from_jax_params(p), torch.from_numpy(x),
                                  None if st is None
                                  else torch.from_numpy(st))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-6)
        np.testing.assert_allclose(_np(ts), np.asarray(js), atol=0)


def test_weights_carry_key_for_key():
    """``from_jax_params`` carries the ``blocks`` / ``tail`` trees (conv
    weights, lru_lambda, the tied, scaled embedding) across unchanged:
    the port's specs have the JAX tree's keys and shapes, leaf for leaf."""
    cfg, _, pcfg, np_params = _setup()
    specs = port_registry.build(pcfg).specs
    assert set(specs) == set(np_params) == {"embed", "blocks", "tail",
                                            "final_norm"}
    got = [tuple(s.shape) for s in tree_leaves(specs)]
    want = [tuple(a.shape) for a in jax.tree.leaves(np_params)]
    assert got == want
    pp = from_jax_params(np_params)
    assert tuple(pp["blocks"]["rec1"]["conv_w"].shape) == (1, 4, 64)
    np.testing.assert_array_equal(_np(pp["tail"]["lru_lambda"]),
                                  np_params["tail"]["lru_lambda"])


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_rg_forward_logits_and_loss_match(kernels, jax_interpret):
    """Smoke logits (S = 20 > 2 x window 8: the windowed attention path
    without kernels, K3's window mask with them) and the loss."""
    cfg, params, pcfg, np_params = _setup()
    pp = from_jax_params(np_params)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))
    x = jr.rg_forward(cfg, params, jnp.asarray(tokens, jnp.int32),
                      use_pallas=kernels)
    want = np.asarray(jax_lm_head(cfg, params, x))
    px = pr.rg_forward(pcfg, pp, torch.from_numpy(tokens),
                       use_kernels=kernels)
    np.testing.assert_allclose(_np(port_lm_head(pcfg, pp, px)), want,
                               atol=1e-4)
    labels = np.roll(tokens, -1, axis=1)
    jl = jr.rg_loss(cfg, params, {"tokens": jnp.asarray(tokens, jnp.int32),
                                  "labels": jnp.asarray(labels, jnp.int32)},
                    use_pallas=kernels)
    tl = pr.rg_loss(pcfg, pp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)},
                    use_kernels=kernels)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_rg_prefill_states_match(kernels, jax_interpret):
    """``rg_prefill`` into ring caches of capacity min(24, window 8) on a
    13-token prompt (the ring wraps): last logits and every state leaf —
    conv and h of each recurrent block, k / v / pos / index of each
    attention block."""
    cfg, params, pcfg, np_params = _setup()
    pp = from_jax_params(np_params)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 13))
    jl, js = jr.rg_prefill(cfg, params, jnp.asarray(prompt, jnp.int32),
                           cache_len=24, use_pallas=kernels)
    tl, ts = pr.rg_prefill(pcfg, pp, torch.from_numpy(prompt), cache_len=24,
                           use_kernels=kernels)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4)
    jleaves = jax.tree_util.tree_leaves_with_path(js)
    tleaves = tree_leaves(ts)
    assert len(jleaves) == len(tleaves)
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        if t.is_floating_point():
            np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-4,
                                       err_msg=str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=str(path))
    assert ts["blocks"]["attn"]["k"].shape[2] == 8          # ring of 8


def test_rg_decode_greedy_16_steps_identical():
    """Prefill a 9-token prompt, then 16 greedy decode steps: the window-8
    ring wraps twice; the streams are identical and the logits agree."""
    cfg, params, pcfg, np_params = _setup()
    pp = from_jax_params(np_params)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 9))
    jlog, js = jr.rg_prefill(cfg, params, jnp.asarray(prompt, jnp.int32),
                             cache_len=32)
    tlog, ts = pr.rg_prefill(pcfg, pp, torch.from_numpy(prompt),
                             cache_len=32)
    step = jax.jit(functools.partial(jr.rg_decode, cfg))
    jtok, ttok = int(jnp.argmax(jlog[0])), int(torch.argmax(tlog[0]))
    j_out, t_out = [jtok], [ttok]
    for _ in range(16):
        jlog, js = step(params, jnp.asarray([[jtok]], jnp.int32), js)
        tlog, ts = pr.rg_decode(pcfg, pp, torch.tensor([[ttok]]), ts)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=1e-4)
        jtok, ttok = int(jnp.argmax(jlog[0])), int(torch.argmax(tlog[0]))
        j_out.append(jtok)
        t_out.append(ttok)
    assert t_out == j_out
    assert int(ts["blocks"]["attn"]["index"][0]) == 9 + 16
