"""Checkpointing, elastic restore and supervised recovery on the port — the
fault-tolerance substrate of the paper's §II-B / §III-B
(``repro_torch.checkpoint``, the port's counterparts of
``tests/test_checkpoint.py``).

  * round trip of the trainer's canonical state (``layerwise``, ZeRO-1
    ``reduce_scatter``, ``compressed``): bit for bit, and the next step's
    loss equal within 1e-6; the on-disk layout is the reference's
    (``step_%09d/``, ``manifest.json``, ``leaf_%05d.npy``);
  * async save; pruning to ``keep``; a bf16 leaf raises;
  * in a 2-process gloo group, a save that fails on rank 0 (a bf16 leaf,
    a full disk under an async save) raises on both ranks, and a later
    save still goes through;
  * ``run_with_recovery`` with a fault injected at step 7 and
    ``ckpt_every=5``: one restart, resumed at step 5, and the losses after
    the resume equal an uninterrupted run's;
  * elastic: 4 gloo processes under ``reduce_scatter`` train 3 steps and
    save; 2 new processes ``restore_elastic`` (the flat ZeRO-1 leaves
    re-split from [4, n/4] to [2, n/2]) and train 3 more steps on the
    following global batches.  All 6 losses lie on the JAX sequential
    curve within 1e-3 (the ZeRO-1 tolerance of ``tests/test_torch_dp.py``);
  * ``Session.train(3, ckpt_dir=, ckpt_every=3)``, then a new Session's
    ``train(3, ckpt_dir=, resume=True)``: on a data set of one repeated
    batch it equals ``train(6)`` within 1e-6; on the default stream the
    checkpoint holds the first session's state bit for bit, and the
    resumed losses equal the JAX sequential curve from that state (params
    and Adam moments at step 3) on the batches of a stream built anew, as
    the reference's ``Session.train`` feeds a resume (atol 1e-4).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from repro.configs import get_config as jax_get_config
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.data import pipeline as jax_pipeline
from repro.data import readers as jax_readers
from repro.models import registry as jax_registry
from repro_torch import api
from repro_torch.checkpoint.checkpoint import (latest_step, leaf_items,
                                               restore_checkpoint,
                                               save_checkpoint)
from repro_torch.checkpoint.elastic import (rebatch_for_mesh,
                                            shrink_mesh_config)
from repro_torch.checkpoint.failures import FaultInjector, run_with_recovery
from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.core.transparent import TransparentTrainer
from repro_torch.data.readers import DataSet
from repro_torch.models import registry
from torch_parity import jax_sequential_curve

ARCH = torch_dp_worker.ARCH
SHAPE = ShapeConfig(name="t", kind="train", seq_len=16, global_batch=8)
#: the spawned runs must finish within this (seconds)
TIMEOUT = 300


def _trainer(allreduce="layerwise"):
    cfg = get_config(ARCH, smoke=True)
    bundle = registry.build(cfg)
    run = RunConfig(model=cfg, shape=SHAPE,
                    mesh=MeshConfig(shape=(1, 1), axis_names=("data", "model"),
                                    allreduce=allreduce),
                    optimizer=OptimizerConfig(name="adam", lr=1e-2))
    return TransparentTrainer(run, bundle.loss_fn, bundle.specs,
                              device="cpu"), cfg


def _batches(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, vocab, (8, 16)).astype(np.int32)}
            for _ in range(n)]


def _host(tree):
    return [(p, np.array(l)) for p, l in leaf_items(tree)]


@pytest.mark.parametrize("allreduce", ["layerwise", "reduce_scatter",
                                       "compressed"])
def test_save_restore_roundtrip(tmp_path, allreduce):
    tr, cfg = _trainer(allreduce)
    batch = _batches(cfg.vocab_size, 1)[0]
    state = tr.init(0)
    state, _ = tr.step(state, batch)
    save_checkpoint(tmp_path, tr.canonical_state(state), state.step)
    assert latest_step(tmp_path) == 1
    manifest = json.loads((tmp_path / "step_000000001" /
                           "manifest.json").read_text())
    saved = _host(tr.canonical_state(state))
    assert manifest["step"] == 1 and manifest["n_leaves"] == len(saved)
    assert manifest["paths"] == [p for p, _ in saved]
    assert manifest["paths"][0].startswith("params/")
    assert (tmp_path / "step_000000001" /
            f"leaf_{len(saved) - 1:05d}.npy").exists()
    tree, step = restore_checkpoint(tmp_path, tr.state_structs())
    restored = tr.load_state(tree)
    assert step == 1 and restored.step == 1
    for (path, a), (_, b) in zip(saved, _host(tr.canonical_state(restored))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    _, m1 = tr.step(state, batch)
    _, m2 = tr.step(restored, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-6
    assert m2["step"] == 2


def test_async_save_pruning_and_bf16(tmp_path):
    tr, _ = _trainer()
    canon = tr.canonical_state(tr.init(0))
    h = save_checkpoint(tmp_path / "a", canon, 5, blocking=False)
    assert h.wait(30), "async save did not complete"
    assert latest_step(tmp_path / "a") == 5 and h.bytes > 0
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path / "p", canon, s, keep=2)
    assert sorted(p.name for p in (tmp_path / "p").glob("step_*")) == [
        "step_000000004", "step_000000005"]
    with pytest.raises(TypeError, match="bfloat16"):
        save_checkpoint(tmp_path / "b", {"w": torch.zeros(3,
                                                          dtype=torch.bfloat16)},
                        1)


def test_failed_save_raises_on_every_rank(tmp_path):
    got = torch_dp_worker.spawn_world(
        torch_dp_worker.run_failed_save, 2, tmp_path / "pg",
        (str(tmp_path / "ckpt"),), TIMEOUT)
    if isinstance(got, tuple):
        pytest.fail("2-process failed-save run failed: " + got[1])
    assert got == [["TypeError", "OSError", 3],
                   ["RuntimeError", "RuntimeError", 3]]


def test_shrink_and_rebatch():
    small = shrink_mesh_config(MeshConfig(shape=(4, 2),
                                          axis_names=("data", "model")), 2)
    assert small.shape == (2, 2)
    with pytest.raises(ValueError):
        shrink_mesh_config(small, 2)
    assert rebatch_for_mesh(8, 4, 2) == 8
    assert rebatch_for_mesh(8, 4, 2, keep_global=False) == 4


def test_run_with_recovery_injected_fault(tmp_path):
    """ULFM-style continued execution: fault at step 7 -> restart from the
    step-5 checkpoint -> finish; the resumed steps equal an uninterrupted
    run's."""
    cfg = get_config(ARCH, smoke=True)
    batches = _batches(cfg.vocab_size, 16)

    def run(ckpt_dir, injector):
        return run_with_recovery(
            make_trainer=lambda attempt: _trainer()[0],
            data_iter_factory=lambda start: iter(batches[start:]),
            ckpt_dir=ckpt_dir, total_steps=12, ckpt_every=5,
            injector=injector)

    _, hist = run(tmp_path / "f", FaultInjector(fail_at_steps=(7,)))
    assert hist["restarts"] == 1
    assert hist["resume_steps"] == [5]
    steps = [s for s, _ in hist["losses"]]
    assert steps == [1, 2, 3, 4, 5, 6, 7] + [6, 7, 8, 9, 10, 11, 12]
    assert hist["straggler_summary"]["steps"] == 14
    _, whole = run(tmp_path / "w", None)
    assert whole["restarts"] == 0
    np.testing.assert_allclose([l for _, l in hist["losses"][7:]],
                               [l for _, l in whole["losses"][5:]],
                               rtol=0, atol=1e-6)
    assert latest_step(tmp_path / "f") == 12


@functools.lru_cache(maxsize=None)
def _elastic_setup():
    cfg = jax_get_config(ARCH, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(0))
    batches = _batches(cfg.vocab_size, 6, seed=1)
    want, _ = jax_sequential_curve(cfg, params, batches,
                                   JaxOptimizerConfig(name="adam", lr=1e-2))
    return jax.tree.map(np.asarray, params), batches, want


def test_elastic_restore_4_to_2_processes(tmp_path):
    """Paper §III-B: DP replication makes losing replicas recoverable.
    Train on 4 replicas, checkpoint, resume on 2 (fresh processes)."""
    params, batches, want = _elastic_setup()
    ckpt = tmp_path / "ckpt"
    big = torch_dp_worker.spawn_world(
        torch_dp_worker.run_elastic, 4, tmp_path / "pg4",
        (str(ckpt), params, batches[:3]), TIMEOUT)
    if isinstance(big, tuple):
        pytest.fail("4-process run failed: " + big[1])
    small = torch_dp_worker.spawn_world(
        torch_dp_worker.run_elastic, 2, tmp_path / "pg2",
        (str(ckpt), params, batches[3:]), TIMEOUT)
    if isinstance(small, tuple):
        pytest.fail("2-process resume failed: " + small[1])
    assert (big["start"], small["start"]) == (0, 3)
    flat4 = [s for s in big["shapes"] if len(s) == 2]
    flat2 = [s for s in small["shapes"] if len(s) == 2]
    assert flat4 and all(s[0] == 1 for s in flat4 + flat2)
    assert flat2[0][1] == -(-flat4[0][1] * 4 // 2)
    np.testing.assert_allclose(big["losses"] + small["losses"], want,
                               atol=1e-3)


def _one_batch_dataset(vocab):
    toks = np.random.default_rng(7).integers(0, vocab, (8, 17),
                                             dtype=np.int32)
    return DataSet(training_data=toks[:, :-1], training_labels=toks[:, 1:])


def test_session_resume_equals_uninterrupted_on_a_repeated_batch(tmp_path):
    kw = dict(seq_len=16, global_batch=8)
    ds = _one_batch_dataset(get_config(ARCH, smoke=True).vocab_size)
    a = api.load(ARCH, smoke=True, device="cpu")
    first = a.train(3, data=ds, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    assert [s.step for s in first.saves] == [3]
    b = api.load(ARCH, smoke=True, device="cpu")
    second = b.train(3, data=ds, ckpt_dir=str(tmp_path), resume=True, **kw)
    assert second.step == 6 and latest_step(tmp_path) == 6
    whole = api.load(ARCH, smoke=True, device="cpu").train(6, data=ds, **kw)
    np.testing.assert_allclose(first.losses + second.losses, whole.losses,
                               rtol=0, atol=1e-6)


def test_session_resume_on_the_default_stream_follows_jax(tmp_path):
    kw = dict(seq_len=16, global_batch=8)
    a = api.load(ARCH, smoke=True, device="cpu")
    a.train(3, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    tree, step = restore_checkpoint(tmp_path, a._trainer.state_structs())
    assert step == 3
    for (path, x), (_, y) in zip(
            leaf_items(a._trainer.canonical_state(a._train_state)),
            leaf_items(tree)):
        np.testing.assert_array_equal(np.array(x), y.numpy(), err_msg=path)
    b = api.load(ARCH, smoke=True, device="cpu")
    got = b.train(3, ckpt_dir=str(tmp_path), resume=True, **kw)
    assert got.step == 6
    # the reference's resume feeds a stream built anew: its first batches
    cfg = jax_get_config(ARCH, smoke=True)
    ds = jax_readers.synthetic_tokens(cfg.vocab_size, 16, num_samples=8 * 64,
                                      seed=0)
    it = iter(jax_pipeline.BatchIterator(ds, 8, seed=0))
    batches = [next(it) for _ in range(3)]
    to_jax = lambda t: jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    opt_state = {"step": jnp.asarray(3, jnp.int32), "m": to_jax(tree.opt["m"]),
                 "v": to_jax(tree.opt["v"])}
    want, _ = jax_sequential_curve(cfg, to_jax(tree.params), batches,
                                   JaxOptimizerConfig(name="adam", lr=1e-3),
                                   opt_state=opt_state)
    np.testing.assert_allclose(got.losses, want, atol=1e-4)
