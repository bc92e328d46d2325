"""The port's trainer slice against the JAX package, on the same numbers.

  * each optimizer's update and ``clip_by_global_norm`` against the JAX
    functions (fp32, atol 1e-6);
  * ``lm_loss`` value and gradients against ``jax.value_and_grad`` of the
    JAX ``lm_loss`` for qwen2.5 smoke (fp32), through ``attention_core``,
    the flash backward (``attn_remat``) and the K3 autograd Function
    (``use_kernels``; on CPU tensors its forward is the plain ``_fwd``),
    with and without per-layer remat (loss atol 1e-5, grads atol 1e-5);
  * ``Session.train`` losses step for step against the JAX
    ``Session.train``'s: the batches its data pipeline draws for the
    session seed, through the JAX sequential step (``torch_parity``), from
    the JAX session's init params carried across as fp32 masters (atol
    1e-4: four adam steps of an fp32 model);
  * ``train(2) + train(2) == train(4)``, and trained params flowing into
    ``serve``.
"""
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
from repro.models import transformer as jt
from repro.optim import optimizers as jax_opt
from repro_torch import api as port_api
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.convert import from_jax_params
from repro_torch.models import transformer as pt
from repro_torch.optim import optimizers as port_opt
from torch_parity import jax_sequential_curve

ARCH = "qwen2.5-14b"


def _tree(rng, scale=1.0):
    return {"b": rng.normal(size=(5,)).astype(np.float32) * scale,
            "w": {"k": rng.normal(size=(3, 4)).astype(np.float32) * scale}}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _assert_trees(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees(got[k], want[k], atol)
        return
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad", "adam",
                                  "adamw"])
def test_optimizer_updates_match_jax(name):
    kw = dict(name=name, lr=0.05, weight_decay=0.1 if name == "adamw" else 0.0)
    jo = jax_opt.make_optimizer(JaxOptimizerConfig(**kw))
    to = port_opt.make_optimizer(OptimizerConfig(**kw))
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = _tree(rng, scale=0.5)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    _assert_trees(_np_tree(tp), _np_tree(jp), atol=1e-6)
    _assert_trees(_np_tree(ts), _np_tree(js), atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])     # clips / leaves as is
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(np.random.default_rng(1), scale=3.0)
    jg, jn = jax_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                         max_norm)
    tg, tn = port_opt.clip_by_global_norm(
        jax.tree.map(torch.from_numpy, grads), max_norm)
    _assert_trees(_np_tree(tg), _np_tree(jg), atol=1e-6)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(port_opt.global_norm(tg)),
                               float(jax_opt.global_norm(jg)), rtol=1e-6)


def _loss_setup(attn_remat, remat):
    cfg = get_config(ARCH, smoke=True).replace(attn_remat=attn_remat,
                                               remat=remat)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(3))
    pcfg = port_get_config(ARCH, smoke=True).replace(attn_remat=attn_remat,
                                                     remat=remat)
    assert cfg.compute_dtype == pcfg.compute_dtype == "float32"
    return cfg, params, pcfg


@pytest.mark.parametrize("attn_remat,use_kernels,remat", [
    (False, False, "none"), (True, False, "none"), (False, True, "none"),
    (False, True, "full"), (True, False, "dots")])
def test_lm_loss_and_grads_match_jax(attn_remat, use_kernels, remat):
    cfg, params, pcfg = _loss_setup(attn_remat, remat)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels[1, :5] = -100
    jloss, jgrads = jax.value_and_grad(jt.lm_loss, argnums=1)(
        cfg, params, {"tokens": jnp.asarray(tokens),
                      "labels": jnp.asarray(labels)})
    tp = from_jax_params(jax.tree.map(np.asarray, params),
                         dtype=torch.float32)
    leaves = {}

    def req(t, path=()):
        if isinstance(t, dict):
            return {k: req(v, path + (k,)) for k, v in t.items()}
        leaves[path] = t.requires_grad_()
        return t
    tp = req(tp)
    tloss = pt.lm_loss(pcfg, tp, {"tokens": torch.from_numpy(tokens),
                                  "labels": torch.from_numpy(labels)},
                       use_kernels=use_kernels)
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    got = float(tloss.detach())
    assert abs(got - float(jloss)) < 1e-5, (got, float(jloss))
    for (path, _), g in zip(leaves.items(), grads):
        want = jgrads
        for k in path:
            want = want[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5,
                                   err_msg="/".join(path))


def test_session_train_matches_jax_session_step_for_step():
    jsess = jax_api.load(ARCH, smoke=True)
    cfg = jsess.model
    # what JAX Session.train(steps=4, seq_len=16, global_batch=8) feeds
    ds = jax_readers.synthetic_tokens(cfg.vocab_size, 16, num_samples=8 * 64,
                                      seed=jsess.seed)
    it = iter(jax_pipeline.BatchIterator(ds, 8, seed=jsess.seed))
    batches = [next(it) for _ in range(4)]
    want, want_gn = jax_sequential_curve(
        cfg, jsess.params, batches, JaxOptimizerConfig(name="adam", lr=1e-3))
    psess = port_api.load(ARCH, smoke=True, device="cpu")
    psess.set_params(from_jax_params(jax.tree.map(np.asarray, jsess.params),
                                     dtype=torch.float32))
    got = psess.train(steps=4, seq_len=16, global_batch=8)
    assert got.step == 4 and len(got.losses) == 4
    np.testing.assert_allclose(got.losses, want, atol=1e-4)
    np.testing.assert_allclose(got.metrics["grad_norm"], want_gn[-1],
                               rtol=1e-3)
    assert got.straggler["steps"] == 4


def test_train_continues_the_stream_and_serve_sees_trained_params():
    kw = dict(seq_len=16, global_batch=4)
    a = port_api.load(ARCH, smoke=True, device="cpu", seed=5)
    first = a.train(2, **kw).losses + a.train(2, **kw).losses
    b = port_api.load(ARCH, smoke=True, device="cpu", seed=5)
    whole = b.train(4, **kw)
    assert first == whole.losses
    assert whole.step == 4 and whole.metrics["step"] == 4
    # serving holds a compute-dtype copy of the trained masters
    masters = b._train_state.params
    trained = b.params
    assert trained["embed"] is not masters["embed"]
    torch.testing.assert_close(trained["embed"], masters["embed"])
    out = b.generate([1, 2, 3, 4, 5], max_new=4)
    c = port_api.load(ARCH, smoke=True, device="cpu", seed=5)
    c.set_params(trained)
    assert c.generate([1, 2, 3, 4, 5], max_new=4) == out
    torch.testing.assert_close(b.engine.params["embed"], masters["embed"])

