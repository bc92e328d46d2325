"""Training the moe, hybrid and ssm families on the port, against the JAX
package on the same numbers.

  * deepseek-v2-lite (MLA + MoE), mixtral-8x22b (sliding window + MoE),
    recurrentgemma-2b (RG-LRU + local attention) and rwkv6-1.6b (WKV),
    smoke configs in fp32: the train loss and every gradient leaf against
    ``jax.value_and_grad`` of the reference's bundle loss (which trains
    with ``use_pallas`` False): loss within 1e-5, grads atol 1e-5; for
    rwkv6 atol 5e-5 of max(1, the leaf's largest |grad|) — its random-
    weight gradients reach 13 (embed), and the JAX package's own fp32
    gradient lies 1.2e-5 of that scale from its fp64 one (embed: 1.17e-4
    of 9.9), so two fp32 evaluations that sum in other orders (a Python
    loop against ``lax.scan``) differ by about twice that (2.7e-5 here).
    Mixtral and recurrentgemma also run with ``use_kernels`` (attention
    through K3's autograd Function; on a CPU tensor its forward is the
    plain ``_fwd``, its backward ``_bwd``).  The MoE loss is GShard
    capacity routing plus the auxiliary loss, as the reference trains;
  * ``Session.train(steps=4, seq_len=16, global_batch=8)`` against the
    JAX sequential curve (``torch_parity.jax_sequential_curve``) on the
    batches the JAX ``Session.train`` draws, from its init params carried
    across as fp32 masters: losses atol 1e-4, last grad norm rtol 1e-3.
    rwkv6 under adam (eps 1e-8) is held looser, atol 1e-3 and rtol 0.06:
    Adam's first step moves every element by ±lr by the sign of its
    gradient, and one w_r element's gradient (6e-8, against the leaf's
    0.91) is rounding noise that takes opposite signs in the two
    packages; the random-weight rwkv6 (grad norms 60-115) answers with
    step-3 losses 1.64e-4 and step-4 grad norms 3.1% apart.  The JAX
    package's own eager and jitted adam curves part by 9e-3 at step 4,
    its fp32 and fp64 ones by 1.1% in grad norm.  rwkv6 is also held at
    the strict bounds under adam with eps 1e-3, where a gradient that
    small moves its weight by no more than lr x 6e-5 (losses within
    3.8e-6, grad norm 6.3e-5 apart), and under momentum, linear in the
    gradient (1e-6 and 1.1e-4);
  * the recurrent losses never reach K9 / K10: with both wrappers made to
    cut the graph as their CUDA launch would, the RG-LRU gate and WKV
    leaves still get a nonzero gradient, and neither wrapper runs;
  * every K3 call under grad on a family's training path goes through the
    autograd Function (``models/flash_vjp.py``), once a layer with
    attention, and never through the raw entry point.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import get_config
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.data import pipeline as jax_pipeline
from repro.data import readers as jax_readers
from repro.models import registry as jax_registry
from repro_torch import api as port_api
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.convert import from_jax_params
from repro_torch.core.transparent import _value_and_grad
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import flash_vjp
from repro_torch.models import registry as port_registry
from torch_parity import jax_sequential_curve

ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x22b", "recurrentgemma-2b",
         "rwkv6-1.6b"]
#: grads atol as a share of max(1, the leaf's largest |grad|), where the
#: module docstring states a looser bound than 1e-5
GRAD_SCALE_TOL = {"rwkv6-1.6b": 5e-5}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_config(arch, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(3))
    pcfg = port_get_config(arch, smoke=True)
    assert cfg.compute_dtype == pcfg.compute_dtype == "float32"
    return cfg, params, pcfg


def _batch(cfg, S=24):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels[1, :5] = -100
    return {"tokens": tokens, "labels": labels}


def _port_grads(arch, use_kernels, batch):
    cfg, params, pcfg = _setup(arch)
    loss_fn = functools.partial(port_registry.build(pcfg).loss_fn,
                                use_kernels=use_kernels)
    tp = from_jax_params(jax.tree.map(np.asarray, params),
                         dtype=torch.float32)
    return _value_and_grad(loss_fn, tp,
                           {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    """The reference's loss and {path: grad} on ``_batch`` (shared by the
    kernel and plain cases)."""
    cfg, params, _ = _setup(arch)
    loss, grads = jax.jit(jax.value_and_grad(jax_registry.build(cfg).loss_fn))(
        params, jax.tree.map(jnp.asarray, _batch(cfg)))
    return float(loss), dict(_paths(jax.tree.map(np.asarray, grads)))


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch,use_kernels", [
    ("deepseek-v2-lite-16b", False), ("mixtral-8x22b", False),
    ("mixtral-8x22b", True), ("recurrentgemma-2b", False),
    ("recurrentgemma-2b", True), ("rwkv6-1.6b", False)])
def test_train_loss_and_grads_match_jax(arch, use_kernels):
    cfg, _, _ = _setup(arch)
    batch = _batch(cfg)
    jloss, want = _jax_grads(arch)
    tloss, tgrads = _port_grads(arch, use_kernels, batch)
    assert abs(float(tloss) - jloss) < 1e-5, (float(tloss), jloss)
    got = dict(_paths(tgrads))
    assert set(got) == set(want)
    for path, g in got.items():
        atol = 1e-5
        if arch in GRAD_SCALE_TOL:
            atol = GRAD_SCALE_TOL[arch] * max(1.0,
                                              float(np.abs(want[path]).max()))
        np.testing.assert_allclose(g.numpy(), want[path], atol=atol,
                                   err_msg="/".join(path))


#: (losses atol, grad-norm rtol) where the module docstring states a
#: looser bound than (1e-4, 1e-3)
CURVE_TOL = {("rwkv6-1.6b", "adam"): (1e-3, 0.06)}
CURVE_OPT = {"adam": dict(name="adam", lr=1e-3),
             "adam-eps1e-3": dict(name="adam", lr=1e-3, eps=1e-3),
             "momentum": dict(name="momentum", lr=1e-2)}


@pytest.mark.parametrize("arch,optimizer", [(a, "adam") for a in ARCHS]
                         + [("rwkv6-1.6b", "adam-eps1e-3"),
                            ("rwkv6-1.6b", "momentum")])
def test_session_train_matches_jax_sequential_curve(arch, optimizer):
    jsess = jax_api.load(arch, smoke=True)
    cfg = jsess.model
    # what JAX Session.train(steps=4, seq_len=16, global_batch=8) feeds
    ds = jax_readers.synthetic_tokens(cfg.vocab_size, 16, num_samples=8 * 64,
                                      seed=jsess.seed)
    it = iter(jax_pipeline.BatchIterator(ds, 8, seed=jsess.seed))
    batches = [next(it) for _ in range(4)]
    opt = CURVE_OPT[optimizer]
    want, want_gn = jax_sequential_curve(
        cfg, jsess.params, batches, JaxOptimizerConfig(**opt))
    psess = port_api.load(arch, smoke=True, device="cpu")
    psess.set_params(from_jax_params(jax.tree.map(np.asarray, jsess.params),
                                     dtype=torch.float32))
    got = psess.train(steps=4, seq_len=16, global_batch=8,
                      optimizer=OptimizerConfig(**opt))
    assert got.step == 4 and len(got.losses) == 4
    atol, rtol = CURVE_TOL.get((arch, optimizer), (1e-4, 1e-3))
    np.testing.assert_allclose(got.losses, want, atol=atol)
    np.testing.assert_allclose(got.metrics["grad_norm"], want_gn[-1],
                               rtol=rtol)


#: the recurrence's parameters in each recurrent family (gates, decay, bonus)
GATE_LEAVES = {
    "recurrentgemma-2b": ("lru_wa", "lru_ba", "lru_wx", "lru_bx",
                          "lru_lambda"),
    "rwkv6-1.6b": ("decay_w0", "decay_a", "decay_b", "bonus_u", "mu_w"),
}


@pytest.mark.parametrize("arch", sorted(GATE_LEAVES))
def test_recurrent_gates_get_gradient_without_the_kernels(arch, monkeypatch):
    """The CUDA K9 / K10 fill a ``torch.empty`` output, which has no
    ``grad_fn``.  Here their wrappers do the same on the CPU (a detached
    output, and a count), and the loss with ``use_kernels`` must reach
    neither: every gate / WKV leaf gets a nonzero gradient."""
    calls = []

    def cut(fn, name):
        def wrapped(*a, **kw):
            calls.append(name)
            out = fn(*a, **kw)
            return tuple(o.detach() for o in out) if isinstance(out, tuple) \
                else out.detach()
        return wrapped
    monkeypatch.setattr(lru_ops, "lru_scan_kernel",
                        cut(lru_ops.lru_scan_kernel, "K9"))
    monkeypatch.setattr(wkv_ops, "wkv6_kernel", cut(wkv_ops.wkv6_kernel,
                                                    "K10"))
    cfg, _, _ = _setup(arch)
    _, grads = _port_grads(arch, True, _batch(cfg))
    assert calls == []
    checked = 0
    for path, g in _paths(grads):
        if path[-1] in GATE_LEAVES[arch]:
            assert float(g.abs().max()) > 0, "/".join(path)
            checked += 1
    assert checked >= len(GATE_LEAVES[arch])


@pytest.mark.parametrize("arch,layers", [
    ("qwen2.5-14b", 3), ("mixtral-8x22b", 2), ("recurrentgemma-2b", 1),
    ("deepseek-v2-lite-16b", 0), ("rwkv6-1.6b", 0)])
def test_k3_under_grad_goes_through_the_autograd_function(arch, layers,
                                                          monkeypatch):
    """One Function call a layer with attention (smoke remat is none; MLA
    trains through the expanded attention, rwkv6 has none), and the raw
    ``flash_attention`` entry point is never called."""
    _, _, pcfg = _setup(arch) if arch != "qwen2.5-14b" else (
        None, None, port_get_config(arch, smoke=True))
    assert pcfg.remat == "none"
    calls = []
    apply = flash_vjp.FlashAttention.apply

    def counted(*a):
        calls.append(torch.is_grad_enabled() and a[0].requires_grad)
        return apply(*a)
    monkeypatch.setattr(flash_vjp.FlashAttention, "apply", counted)
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **kw: pytest.fail("raw K3 entry point"))
    bundle = port_registry.build(pcfg)
    params = bundle.init_params(torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    loss, grads = _value_and_grad(
        functools.partial(bundle.loss_fn, use_kernels=True), params, batch)
    assert calls == [True] * layers
    assert torch.isfinite(loss)
