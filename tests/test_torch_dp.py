"""The paper's Fig. 7 on the port: synchronous data-parallel training in 4
gloo processes equals the sequential run, step for step.

The port's ``TransparentTrainer`` runs in 4 processes
(``torch.multiprocessing`` spawn, ``init_method="file://..."``, the worker
is ``tests/torch_dp_worker.py``) on stablelm-1.6b smoke (fp32), 6 steps of
8 x 16 tokens, each rank on its 2-row slice of every global batch: the four
optimizers with the default strategy (layerwise), and every strategy with
adam (``hierarchical`` as 2 pods x 2 replicas).  Its losses are held
against the JAX sequential (one replica, full batch) curve on the same
init params and batches (``torch_parity.jax_sequential_curve``), as
``tests/test_equivalence.py`` holds the JAX package's DP runs: atol 5e-4,
1e-3 for ``reduce_scatter`` and 3e-2 for ``compressed`` (the JAX trainer
tests' tolerances: ZeRO-1 sums in another order, the bf16 wire rounds).

The processes start once per module (a fixture runs every case); each
parametrised test asserts its own case.  Each child is joined with a
timeout and killed on expiry, so a hang fails the tests instead of eating
the suite's time.
"""
import functools

import jax
import numpy as np
import pytest

import torch_dp_worker
from repro.configs import get_config
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.models import registry as jax_registry
from torch_parity import jax_sequential_curve

WORLD = 4
STEPS = 6
#: the whole 4-process run must finish within this (seconds)
TIMEOUT = 300
OPTIMIZERS = ["sgd", "momentum", "adam", "adagrad"]
STRATEGIES = [("fused", 5e-4), ("layerwise", 5e-4), ("bucketed", 5e-4),
              ("hierarchical", 5e-4), ("reduce_scatter", 1e-3),
              ("compressed", 3e-2)]
#: job name -> (optimizer, strategy); the default strategy is layerwise
JOBS = {**{f"{o}/layerwise": (o, "layerwise") for o in OPTIMIZERS},
        **{f"adam/{s}": ("adam", s) for s, _ in STRATEGIES}}


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config(torch_dp_worker.ARCH, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)}
               for _ in range(STEPS)]
    return cfg, params, batches


@functools.lru_cache(maxsize=None)
def _sequential(optimizer):
    cfg, params, batches = _setup()
    losses, _ = jax_sequential_curve(
        cfg, params, batches, JaxOptimizerConfig(name=optimizer, lr=1e-2))
    return losses


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    _, params, batches = _setup()
    result = torch_dp_worker.spawn_world(
        torch_dp_worker.run, WORLD, tmp_path_factory.mktemp("pg") / "pg",
        (JOBS, jax.tree.map(np.asarray, params), batches), TIMEOUT)
    if isinstance(result, tuple):
        pytest.fail("data-parallel workers failed: " + result[1])
    return result


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_dp4_matches_sequential_for_each_optimizer(dp_run, optimizer):
    """Fig. 7, LM flavour, for each gradient-descent variant of the paper."""
    np.testing.assert_allclose(dp_run[f"{optimizer}/layerwise"],
                               _sequential(optimizer), atol=5e-4,
                               err_msg="distributed != sequential (Fig. 7)")


@pytest.mark.parametrize("strategy,tol", STRATEGIES)
def test_dp4_strategies_match_sequential(dp_run, strategy, tol):
    np.testing.assert_allclose(dp_run[f"adam/{strategy}"],
                               _sequential("adam"), atol=tol)


def test_broadcast_makes_replicas_identical(dp_run):
    """Per-rank seeded inits differ; after the trainer's init (rank-0
    broadcast, the paper's §III-D.1) every replica holds rank 0's."""
    b = dp_run["broadcast"]
    assert b["before"] > 0.1
    assert b["after"] == 0.0
    assert b["off_rank0"] == 0.0
    assert b["masked"] == 0.0            # broadcast_masked, mask = rank 0


def test_value_and_grad_reduces_over_replicas(dp_run):
    """The drop-in primitive: per-rank slices give the whole batch's loss
    and gradient (fp32, atol 1e-6)."""
    assert dp_run["value_and_grad"] < 1e-6
