"""The paper's CNN family on the port, against the JAX package on the same
numbers (``repro_torch.models.cnn`` against ``repro.models.cnn``).

  * ``conv2d`` ("SAME" stride 1 and 2, "VALID" stride 4, as AlexNet's c1)
    and ``maxpool`` (3/2 and 2/2) against the JAX functions: atol 1e-5;
  * TinyCNN: logits, ``cnn_loss`` and every gradient leaf against
    ``jax.value_and_grad`` (loss within 1e-5, grads atol 1e-5);
  * AlexNet's logits at 2 x 227 x 227 x 3 (the only size the reference's
    ``f6`` accepts) within 1e-5 of the largest |logit|: the reference's
    random init on N(0, 1) images gives logits up to 1.6e3, where one fp32
    ulp is 1.2e-4 and the two sides lie 1.2e-3 (JAX) and 2.4e-3 (port)
    from an fp64 forward, so no absolute 1e-4 can hold; measured 2.8e-3
    apart, 1.7e-6 of the scale;
  * TinyCNN's 6-step momentum (lr 1e-2) sequential curve through the
    port's ``TransparentTrainer`` against the JAX sequential curve
    (``torch_parity.jax_sequential_curve`` with ``cnn_loss``): atol 1e-4;
  * the paper's Fig. 7 as published: the same curve from TinyCNN in 4 gloo
    data-parallel processes (``torch_dp_worker.run_cnn``, each rank on its
    2 of every 8 images, the ``layerwise`` all-reduce): atol 5e-4, the
    tolerance ``tests/test_equivalence.py`` holds the JAX package's DP
    runs to.  The processes start once per module.

Weights come from the JAX ``init_params`` and are carried across with
``from_jax_params`` (conv weights stay HWIO: a key-for-key copy).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.models import cnn as jcnn
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.convert import from_jax_params
from repro_torch.core.transparent import TransparentTrainer, _value_and_grad
from repro_torch.models import cnn as pcnn
from repro_torch.models import registry as port_registry
from torch_parity import jax_sequential_curve

STEPS = 6
WORLD = 4
#: the 4-process run must finish within this (seconds)
TIMEOUT = 300


def _t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _tiny():
    params = jax_init_params(jcnn.tinycnn_specs(10), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    batches = [{"images": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                "labels": rng.integers(0, 10, (8,)).astype(np.int32)}
               for _ in range(STEPS)]
    return jax.tree.map(np.asarray, params), batches


def _jax_tiny_loss(p, b):
    return jcnn.cnn_loss(jcnn.tinycnn_forward, p, b, 10)


@functools.lru_cache(maxsize=None)
def _jax_curve():
    params, batches = _tiny()
    losses, _ = jax_sequential_curve(
        None, jax.tree.map(jnp.asarray, params), batches,
        JaxOptimizerConfig(name="momentum", lr=1e-2), loss_fn=_jax_tiny_loss)
    return losses


@pytest.mark.parametrize("k,cin,cout,stride,padding,size", [
    (3, 3, 16, 1, "SAME", 16), (5, 8, 12, 1, "SAME", 13),
    (4, 3, 5, 2, "SAME", 11), (11, 3, 8, 4, "VALID", 35)])
def test_conv2d_matches_jax(k, cin, cout, stride, padding, size):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    p = {"w": rng.normal(size=(k, k, cin, cout)).astype(np.float32) * 0.2,
         "b": rng.normal(size=(cout,)).astype(np.float32)}
    want = np.asarray(jcnn.conv2d(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), stride, padding))
    got = pcnn.conv2d(jax.tree.map(_t, p), _t(x), stride, padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("k,s,size", [(3, 2, 55), (3, 2, 13), (2, 2, 16),
                                      (2, 2, 7)])
def test_maxpool_matches_jax(k, s, size):
    x = np.random.default_rng(size).normal(size=(2, size, size, 5)).astype(
        np.float32)
    want = np.asarray(jcnn.maxpool(jnp.asarray(x), k, s))
    got = pcnn.maxpool(_t(x), k, s)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_tinycnn_logits_loss_and_grads_match_jax():
    params, batches = _tiny()
    b = batches[0]
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, b)
    want_logits = np.asarray(jcnn.tinycnn_forward(jp, jb["images"]))
    jloss, jgrads = jax.value_and_grad(_jax_tiny_loss)(jp, jb)
    tp = from_jax_params(params, dtype=torch.float32)
    tb = {k: _t(v) for k, v in b.items()}
    np.testing.assert_allclose(
        pcnn.tinycnn_forward(tp, tb["images"]).numpy(), want_logits,
        atol=1e-5)
    tloss, tgrads = _value_and_grad(
        lambda p, b: pcnn.cnn_loss(pcnn.tinycnn_forward, p, b, 10), tp, tb)
    assert abs(float(tloss) - float(jloss)) < 1e-5
    # conv weights are used through an OIHW view of their HWIO leaf; the
    # trainer hands the collectives contiguous gradients all the same
    assert all(g.is_contiguous() for layer in tgrads.values()
               for g in layer.values())
    for layer in jgrads:
        for leaf in jgrads[layer]:
            np.testing.assert_allclose(
                tgrads[layer][leaf].numpy(), np.asarray(jgrads[layer][leaf]),
                atol=1e-5, err_msg=f"{layer}/{leaf}")


def test_alexnet_logits_match_jax_at_227():
    specs = jcnn.alexnet_specs()
    params = jax.tree.map(np.asarray, jax_init_params(
        specs, jax.random.PRNGKey(1)))
    images = np.random.default_rng(3).normal(
        size=(2, 227, 227, 3)).astype(np.float32)
    want = np.asarray(jcnn.alexnet_forward(jax.tree.map(jnp.asarray, params),
                                           jnp.asarray(images)))
    assert want.shape == (2, 1000)
    tp = from_jax_params(params, dtype=torch.float32)
    assert sum(t.numel() for layer in tp.values()
               for t in layer.values()) == 62_378_344
    got = pcnn.alexnet_forward(tp, _t(images))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * float(np.abs(want).max()))


def _tiny_trainer(world=1):
    run = RunConfig(
        model=get_config("tinycnn"),
        shape=ShapeConfig(name="t", kind="train", seq_len=16, global_batch=8),
        mesh=MeshConfig(shape=(world, 1), axis_names=("data", "model")),
        optimizer=OptimizerConfig(name="momentum", lr=1e-2))
    return TransparentTrainer(
        run, lambda p, b: pcnn.cnn_loss(pcnn.tinycnn_forward, p, b, 10),
        pcnn.tinycnn_specs(10), device="cpu")


def test_tinycnn_sequential_curve_matches_jax():
    params, batches = _tiny()
    tr = _tiny_trainer()
    state = tr.init(0, params=from_jax_params(params, dtype=torch.float32))
    losses = []
    for b in batches:
        state, m = tr.step(state, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, _jax_curve(), atol=1e-4)
    assert losses[-1] < losses[0]


def test_registry_names_the_way_to_train_the_cnn_family():
    with pytest.raises(NotImplementedError,
                       match="TransparentTrainer") as e:
        port_registry.build(get_config("alexnet"))
    assert "not ported" not in str(e.value)
    assert "repro_torch.models.cnn" in str(e.value)


@pytest.fixture(scope="module")
def dp_curve(tmp_path_factory):
    params, batches = _tiny()
    result = torch_dp_worker.spawn_world(
        torch_dp_worker.run_cnn, WORLD, tmp_path_factory.mktemp("pg") / "pg",
        (params, batches), TIMEOUT)
    if isinstance(result, tuple):
        pytest.fail("data-parallel workers failed: " + result[1])
    return result


def test_fig7_tinycnn_dp4_matches_jax_sequential(dp_curve):
    """Paper Fig. 7 as published: CNN image classification, 4 replicas
    against the sequential run."""
    assert len(dp_curve) == STEPS
    np.testing.assert_allclose(dp_curve, _jax_curve(), atol=5e-4,
                               err_msg="distributed != sequential (Fig. 7)")
