"""The port's RWKV-6 (Finch) against the JAX package, on the same weights
and inputs.

Inputs are made with numpy from a seed; weights come from the JAX
``bundle.init_params`` and are carried across with ``from_jax_params``.
Where the JAX function reaches the Pallas WKV kernel (K10,
``use_pallas=True``) it runs in interpret mode, as the JAX package's own
kernel tests run it on the CPU; the port's ``use_kernels=True`` runs the
kernel's plain version here (CPU tensors).

Tolerances: K10's plain version against ``wkv6_ref`` and the Pallas kernel
1e-4 on the outputs and states (the JAX package's own kernel-test bound:
the same recurrence, einsum summation order differs; s0 ~ N(0, 1) keeps
the state O(10)); the smoke model's logits and prefill states 1e-4 (fp32
through 3 layers); greedy tokens identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.rwkv6_wkv import ops as jax_wkv_ops
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_wkv_ref
from repro.models import registry as jax_registry
from repro.models import rwkv6 as jr
from repro.models.transformer import lm_head as jax_lm_head
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.rwkv6_wkv import kernel as port_kernel
from repro_torch.kernels.rwkv6_wkv import ops as port_ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref as port_wkv_ref
from repro_torch.models import registry as port_registry
from repro_torch.models import rwkv6 as pr
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import lm_head as port_lm_head

ARCH = "rwkv6-1.6b"

#: the (B, S, H, hd, block_t, dtype) grid of tests/test_kernels.py
WKV_CASES = [
    (2, 32, 2, 16, 8, "float32"),
    (1, 50, 4, 32, 16, "float32"),   # ragged S
    (2, 16, 1, 64, 8, "float32"),
    (1, 24, 2, 32, 8, "bfloat16"),
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
    """The JAX package's ``use_pallas`` path with the Pallas kernel in
    interpret mode (no TPU here)."""
    monkeypatch.setattr(jax_wkv_ops, "wkv6", functools.partial(
        jax_wkv_ops.wkv6, interpret=True))


def _wkv_inputs(seed, B, S, H, hd, s0_zero=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, hd)))).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = (np.zeros((B, H, hd, hd), np.float32) if s0_zero
          else rng.normal(size=(B, H, hd, hd)).astype(np.float32))
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,S,H,hd,bt,dtype", WKV_CASES)
def test_wkv6_plain_matches_jax(B, S, H, hd, bt, dtype):
    """K10's plain version, in the model layout (through the kernel
    wrapper, which takes it for CPU tensors, and through
    ``use_kernel=False``) and in its own [B*H, S, hd] layout, equals the
    JAX oracle and the Pallas kernel in interpret mode, with s0 != 0; no
    launch is counted."""
    r, k, v, w, u, s0 = _wkv_inputs(S * 10 + hd, B, S, H, hd)
    rd, kd, vd = (np.array(jnp.asarray(t, JNP[dtype]).astype(jnp.float32))
                  for t in (r, k, v))
    jout, js = jax_wkv_ops.wkv6(
        *(jnp.asarray(t, JNP[dtype]) for t in (r, k, v)), jnp.asarray(w),
        jnp.asarray(u), jnp.asarray(s0), interpret=True, block_t=bt)

    def flat(t):
        return t.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    uf = np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd)
    oref, sref = jax_wkv_ref(*(jnp.asarray(flat(t)) for t in (rd, kd, vd, w)),
                             jnp.asarray(uf), jnp.asarray(
                                 s0.reshape(B * H, hd, hd)))
    want_out = np.asarray(oref).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    want_s = np.asarray(sref).reshape(B, H, hd, hd)
    tin = [torch.from_numpy(t).to(TORCH[dtype]) for t in (r, k, v)]
    before = port_kernel.wkv6_kernel.launches
    for use_kernel in (True, False):
        out, s_last = port_ops.wkv6(*tin, torch.from_numpy(w),
                                    torch.from_numpy(u), torch.from_numpy(s0),
                                    use_kernel=use_kernel)
        for want in (want_out, np.asarray(jout)):
            np.testing.assert_allclose(_np(out), want, atol=1e-4)
        for want in (want_s, np.asarray(js)):
            np.testing.assert_allclose(_np(s_last), want, atol=1e-4)
    assert port_kernel.wkv6_kernel.launches == before
    po, ps = port_wkv_ref(*(torch.from_numpy(flat(t)) for t in (rd, kd, vd, w)),
                          torch.from_numpy(uf.copy()),
                          torch.from_numpy(s0.reshape(B * H, hd, hd)))
    np.testing.assert_allclose(_np(po), np.asarray(oref), atol=1e-4)
    np.testing.assert_allclose(_np(ps), np.asarray(sref), atol=1e-4)


def test_wkv6_state_threading():
    """Splitting a sequence in two and threading the state equals one pass
    (the invariant prefill / decode relies on), for the plain version and
    against the Pallas kernel's single pass."""
    B, S, H, hd = 1, 16, 2, 16
    r, k, v, w, u, s0 = _wkv_inputs(9, B, S, H, hd, s0_zero=True)
    T = [torch.from_numpy(t) for t in (r, k, v, w)]
    tu, ts0 = torch.from_numpy(u), torch.from_numpy(s0)
    full, s_full = port_ops.wkv6(*T, tu, ts0, use_kernel=True)
    h = S // 2
    o1, s1 = port_ops.wkv6(*(t[:, :h] for t in T), tu, ts0, use_kernel=True)
    o2, s2 = port_ops.wkv6(*(t[:, h:] for t in T), tu, s1, use_kernel=True)
    np.testing.assert_allclose(_np(torch.cat([o1, o2], 1)), _np(full),
                               atol=1e-5)
    np.testing.assert_allclose(_np(s2), _np(s_full), atol=1e-5)
    jfull, js = jax_wkv_ops.wkv6(*(jnp.asarray(t) for t in (r, k, v, w)),
                                 jnp.asarray(u), jnp.asarray(s0),
                                 interpret=True, block_t=8)
    np.testing.assert_allclose(_np(full), np.asarray(jfull), atol=1e-4)
    np.testing.assert_allclose(_np(s2), np.asarray(js), atol=1e-4)


def test_weights_carry_key_for_key():
    """``from_jax_params`` carries the ``layers`` tree (decay_a/b,
    bonus_u, gn_scale/bias, ...) across unchanged: the port's specs have
    the JAX tree's keys and shapes, leaf for leaf."""
    cfg, _, pcfg, np_params = _setup()
    specs = port_registry.build(pcfg).specs
    got = [tuple(s.shape) for s in tree_leaves(specs)]
    want = [tuple(a.shape) for a in jax.tree.leaves(np_params)]
    assert got == want
    pp = from_jax_params(np_params)
    for name in ("decay_a", "decay_b", "bonus_u", "gn_scale", "gn_bias"):
        np.testing.assert_array_equal(_np(pp["layers"]["tm"][name]),
                                      np_params["layers"]["tm"][name])


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_rwkv_forward_logits_and_loss_match(kernels, jax_interpret):
    cfg, params, pcfg, np_params = _setup()
    pp = from_jax_params(np_params)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    x = jr.rwkv_forward(cfg, params, jnp.asarray(tokens, jnp.int32),
                        use_pallas=kernels)
    want = np.asarray(jax_lm_head(cfg, params, x))
    px = pr.rwkv_forward(pcfg, pp, torch.from_numpy(tokens),
                         use_kernels=kernels)
    np.testing.assert_allclose(_np(port_lm_head(pcfg, pp, px)), want,
                               atol=1e-4)
    labels = np.roll(tokens, -1, axis=1)
    jl = jr.rwkv_loss(cfg, params, {"tokens": jnp.asarray(tokens, jnp.int32),
                                    "labels": jnp.asarray(labels, jnp.int32)},
                      use_pallas=kernels)
    tl = pr.rwkv_loss(pcfg, pp, {"tokens": torch.from_numpy(tokens),
                                 "labels": torch.from_numpy(labels)},
                      use_kernels=kernels)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_rwkv_prefill_states_match(kernels, jax_interpret):
    """``rwkv_prefill``: last logits and every state leaf (time-mix shift
    ``x`` and WKV state ``s``, channel-mix shift ``cm``) per layer."""
    cfg, params, pcfg, np_params = _setup()
    pp = from_jax_params(np_params)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 13))
    jl, js = jr.rwkv_prefill(cfg, params, jnp.asarray(prompt, jnp.int32),
                             use_pallas=kernels)
    tl, ts = pr.rwkv_prefill(pcfg, pp, torch.from_numpy(prompt),
                             use_kernels=kernels)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4)
    jleaves = jax.tree_util.tree_leaves_with_path(js)
    tleaves = tree_leaves(ts)
    assert len(jleaves) == len(tleaves) == 3
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-4,
                                   err_msg=str(path))


def test_rwkv_decode_greedy_16_steps_identical():
    cfg, params, pcfg, np_params = _setup()
    pp = from_jax_params(np_params)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 9))
    jlog, js = jr.rwkv_prefill(cfg, params, jnp.asarray(prompt, jnp.int32))
    tlog, ts = pr.rwkv_prefill(pcfg, pp, torch.from_numpy(prompt))
    step = jax.jit(functools.partial(jr.rwkv_decode, cfg))
    jtok, ttok = int(jnp.argmax(jlog[0])), int(torch.argmax(tlog[0]))
    j_out, t_out = [jtok], [ttok]
    for _ in range(16):
        jlog, js = step(params, jnp.asarray([[jtok]], jnp.int32), js)
        tlog, ts = pr.rwkv_decode(pcfg, pp, torch.tensor([[ttok]]), ts)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=1e-4)
        jtok, ttok = int(jnp.argmax(jlog[0])), int(torch.argmax(tlog[0]))
        j_out.append(jtok)
        t_out.append(ttok)
    assert t_out == j_out
    np.testing.assert_allclose(_np(ts["tm"]["s"]), np.asarray(js["tm"]["s"]),
                               atol=1e-4)
