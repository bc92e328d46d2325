"""The port's trainer over meshes of gloo processes against the JAX
sequential curve: mesh transparency for training.

Each rank is one mesh device (``tests/torch_mesh_worker.py:run_train``);
every rank trains on its data-parallel slice of each global batch (8 x 16
tokens, 3 steps, adam at 1e-2) from the JAX init carried across with
``convert.from_jax_params``.  The losses must equal the JAX sequential
(one replica, whole batch) curve on the same weights and batches
(``torch_parity.jax_sequential_curve``) within the port's trainer bound
(5e-4, ``tests/test_torch_dp.py``'s), and every rank must report the same
ones.  The meshes (4 processes): qwen on 2x2 replicated (tensor parallel
over two ranks in each of two replicas), on 4x1 and 2x2 with
``dp_mode="fsdp"``, on 2x2 with ZeRO-1 (``reduce_scatter``, 1e-3 as
there), on 2x1x2 (pod x data x model) with the hierarchical strategy; deepseek on 1x4 (expert-parallel MoE, MLA heads; and with
each expert's hidden dim over the axis instead),
recurrentgemma (the RG-LRU width over the model axis) and rwkv6 (WKV
heads, under momentum) on 2x2.  Also
``Session.train(mesh="2x2")`` beside ``TransparentTrainer.from_bundle`` on
the same mesh (identical losses), and the checkpoint: 8 processes train 2
steps on (4, 2) and save; 4 fresh processes restore that onto (2, 2)
(``restore_elastic``: the canonical state is whole, each rank re-shards
it), train 2 more and save; one process restores that onto 1x1 and trains
2 more — the 6 losses are the sequential curve's; and on every job
``load_state(canonical_state(state))`` gives each rank its state back.
"""
import functools
import threading

import jax
import numpy as np
import pytest

import torch_dp_worker
import torch_mesh_worker
from repro.configs import get_config
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.models import registry as jax_registry
from repro_torch.checkpoint.elastic import restore_elastic
from repro_torch.configs.base import MeshConfig
from torch_parity import jax_sequential_curve

#: each multi-process run must finish within this (seconds)
TIMEOUT = 600
#: steps of the mesh jobs; the checkpoint chain runs 2 + 2 + 2
STEPS = 3
CHAIN = 6
QWEN = "qwen2.5-14b"
ATOL = 5e-4
DM = ("data", "model")
ADAM = {"name": "adam", "lr": 1e-2}
#: name -> (arch, mesh, optimizer).  deepseek trains without data
#: parallelism: GShard capacity groups the tokens a rank holds, so a
#: replica's routing is not the whole batch's (the JAX package's manual
#: data-parallel region has the same semantics).  rwkv6 steps with
#: momentum: its random-weight gradients (norms 60-115) part the port
#: from the reference under adam even on one process
#: (``tests/test_torch_train_families.py``)
JOBS = {
    "qwen/2x2": (QWEN, MeshConfig(shape=(2, 2), axis_names=DM), ADAM),
    "qwen/4x1/fsdp": (QWEN, MeshConfig(shape=(4, 1), axis_names=DM,
                                       dp_mode="fsdp"), ADAM),
    "qwen/2x2/fsdp": (QWEN, MeshConfig(shape=(2, 2), axis_names=DM,
                                       dp_mode="fsdp"), ADAM),
    "qwen/2x2/reduce_scatter": (QWEN, MeshConfig(
        shape=(2, 2), axis_names=DM, allreduce="reduce_scatter"), ADAM),
    "qwen/2x1x2/hierarchical": (QWEN, MeshConfig(
        shape=(2, 1, 2), axis_names=("pod", "data", "model"),
        allreduce="hierarchical"), ADAM),
    "deepseek/1x4": ("deepseek-v2-lite-16b",
                     MeshConfig(shape=(1, 4), axis_names=DM), ADAM),
    # each expert's hidden dim over the model axis (the rule for an
    # expert count that does not divide it), forced by an override
    "deepseek/1x4/expert_mlp": ("deepseek-v2-lite-16b", MeshConfig(
        shape=(1, 4), axis_names=DM,
        rules_override=(("expert", None), ("expert_mlp", "model"))), ADAM),
    "recurrentgemma/2x2": ("recurrentgemma-2b",
                           MeshConfig(shape=(2, 2), axis_names=DM), ADAM),
    "rwkv6/2x2": ("rwkv6-1.6b", MeshConfig(shape=(2, 2), axis_names=DM),
                  {"name": "momentum", "lr": 1e-2}),
}


@functools.lru_cache(maxsize=None)
def _setup(arch, steps=CHAIN):
    cfg = get_config(arch, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size,
                                       (8, 16)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (8, 16)).astype(np.int32)}
               for _ in range(steps)]
    return cfg, params, batches


@functools.lru_cache(maxsize=None)
def _sequential(arch, steps=STEPS, opt=tuple(ADAM.items())):
    cfg, params, batches = _setup(arch)
    return jax_sequential_curve(cfg, params, batches[:steps],
                                JaxOptimizerConfig(**dict(opt)))


def _spawn(tmp, world, jobs, ckpt, session_arch):
    archs = {j[0] for j in jobs.values()} | {c[0] for c in ckpt.values()}
    weights = {a: jax.tree.map(np.asarray, _setup(a)[1]) for a in archs}
    # the jobs run STEPS steps; the checkpoint chain slices its own
    batches = {a: _setup(a)[2] for a in archs}
    result = torch_dp_worker.spawn_world(
        torch_mesh_worker.run_train, world, tmp / f"pg{world}",
        (jobs, STEPS, weights, batches, ckpt, session_arch), TIMEOUT)
    if isinstance(result, tuple):
        pytest.fail(f"{world}-process mesh run failed: " + result[1])
    assert result["agree"], "the ranks' results differ"
    return result["results"]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The ranks' results; the JAX curves are made (and cached) here
    while the processes train."""
    tmp = tmp_path_factory.mktemp("mesh")
    ckpt = str(tmp / "ckpt")
    for arch in {j[0] for j in JOBS.values()}:
        _setup(arch)                       # before the thread reads them
    out = {}

    def spawn():
        big = _spawn(tmp, 8, {}, {"save": (QWEN, MeshConfig(
            shape=(4, 2), axis_names=DM), ckpt, 2)}, None)
        small = _spawn(tmp, 4, JOBS, {"resume": (QWEN, MeshConfig(
            shape=(2, 2), axis_names=DM), ckpt, 2)}, QWEN)
        out.update(small, save=big["save"], ckpt=ckpt)

    errors = []
    ranks = threading.Thread(target=lambda: _record(spawn, errors))
    ranks.start()
    try:
        for arch, _, opt in JOBS.values():
            _sequential(arch, opt=tuple(opt.items()))
        _sequential(QWEN, CHAIN)
    finally:
        ranks.join(timeout=3 * TIMEOUT)
    assert not ranks.is_alive(), "mesh workers did not finish"
    if errors:
        raise errors[0]
    return out


def _record(fn, errors):
    try:
        fn()
    except BaseException as e:       # re-raised by the fixture
        errors.append(e)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_mesh_losses_match_the_sequential_curve(mesh_run, job):
    arch, mesh, opt = JOBS[job]
    losses, norms, round_trip = mesh_run[job]
    want, want_norms = _sequential(arch, opt=tuple(opt.items()))
    # ZeRO-1 sums in another order (tests/test_torch_dp.py's bound)
    atol = 1e-3 if mesh.allreduce == "reduce_scatter" else ATOL
    np.testing.assert_allclose(losses, want, atol=atol)
    np.testing.assert_allclose(norms[0], want_norms[0], rtol=1e-3)
    assert round_trip, "load_state(canonical_state(s)) != s on some rank"


def test_session_train_on_a_mesh_equals_the_transparent_trainer(mesh_run):
    got, ref = mesh_run["session"]
    assert len(got) == 3 and got == ref            # identical, not close


def test_checkpoint_4x2_to_2x2_to_1x1(mesh_run):
    """(4, 2) -> (2, 2) -> 1x1: each restore re-shards the whole
    canonical state onto its mesh and the run continues on the curve."""
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.core.transparent import TransparentTrainer
    from repro_torch.models import registry

    start0, first = mesh_run["save"]
    start1, second = mesh_run["resume"]
    assert (start0, start1) == (0, 2)
    cfg = port_get_config(QWEN, smoke=True)
    run = RunConfig(model=cfg, shape=torch_mesh_worker.SHAPE,
                    mesh=MeshConfig(shape=(1, 1), axis_names=DM),
                    optimizer=OptimizerConfig(name="adam", lr=1e-2))
    tr = TransparentTrainer.from_bundle(run, registry.build(cfg),
                                        device="cpu")
    state, start = restore_elastic(mesh_run["ckpt"], tr)
    assert start == 4
    third = []
    for b in _setup(QWEN)[2][4:]:
        state, m = tr.step(state, b)
        third.append(float(m["loss"]))
    want, _ = _sequential(QWEN, CHAIN)
    np.testing.assert_allclose(first + second + third, want, atol=ATOL)
