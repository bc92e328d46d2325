"""The port's command-line launchers, run as a user runs them (CPU).

``python -m repro_torch.launch.train`` / ``.serve`` with ``--device cpu``
are thin adapters over ``repro_torch.api``: their printed losses and
streams are the Session's.  The launchers start together in one module
fixture, each a subprocess joined with a timeout (killed on expiry):

  * ``launch.train --smoke --steps 3``: the printed step-1 and final
    losses are ``Session.train``'s in this process;
  * the same under ``torch.distributed.run --nproc-per-node 2`` with
    ``--mesh 2`` (two gloo processes): each rank trains on its shard of
    the synthetic corpus (the paper's rank-sharded readers), so the run
    equals one process stepping on the two ranks' local batches joined —
    the printed losses are that sequential run's, on every rank;
  * ``launch.serve --smoke --requests 3``: the printed streams are
    ``Session.serve``'s on the launcher's prompts;
  * ``launch.train --mesh 2x2`` under ``--nproc-per-node 4`` (two
    data-parallel replicas, each tensor-parallel over two ranks): the
    printed losses are the joined sequential run's, on every rank;
  * ``launch.serve --mesh 2x2`` under ``--nproc-per-node 4``: rank 0
    prints the one-process streams.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import api
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.core.transparent import TransparentTrainer
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.readers import synthetic_tokens

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu", "--steps",
         "3", "--seq-len", "16", "--global-batch", "8"]
#: each launcher must finish within this (seconds)
TIMEOUT = 240

RUNS = {
    "train": [sys.executable, "-m", "repro_torch.launch.train", *TRAIN],
    "train_dp2": [sys.executable, "-m", "torch.distributed.run",
                  "--standalone", "--nproc-per-node", "2",
                  "-m", "repro_torch.launch.train", *TRAIN, "--mesh", "2"],
    "serve": [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
              "qwen2.5-14b", "--smoke", "--device", "cpu", "--requests", "3",
              "--max-new", "6"],
    "mesh_2x2": [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "4",
                 "-m", "repro_torch.launch.train", *TRAIN, "--mesh", "2x2"],
    "serve_2x2": [sys.executable, "-m", "torch.distributed.run",
                  "--standalone", "--nproc-per-node", "4",
                  "-m", "repro_torch.launch.serve", "--arch", "qwen2.5-14b",
                  "--smoke", "--device", "cpu", "--requests", "3",
                  "--max-new", "6", "--mesh", "2x2"],
}


@pytest.fixture(scope="module")
def runs():
    """name -> (exit code, stdout + stderr) of every launcher, started
    together."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src")] + os.environ.get("PYTHONPATH", "").split(
                   os.pathsep)).rstrip(os.pathsep),
           "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    procs = {n: subprocess.Popen(cmd, cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, cmd in RUNS.items()}
    out = {}
    try:
        for n, p in procs.items():
            try:
                text, _ = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                text += f"\n<killed after {TIMEOUT} s>"
            out[n] = (p.returncode, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _losses(text):
    """The printed step-1 losses (one a rank) and final losses."""
    first = [float(x) for x in re.findall(r"step\s+1\s+loss (\S+)", text)]
    final = [float(x)
             for x in re.findall(r"done: 3 steps, loss ([^,]+),", text)]
    return first, final


def _optimizer():
    return OptimizerConfig(name="adam", lr=1e-3)     # the launcher's defaults


def test_train_prints_the_sessions_losses(runs):
    rc, text = runs["train"]
    assert rc == 0, text
    (first,), (final,) = _losses(text)
    res = api.load("stablelm-1.6b", smoke=True, device="cpu").train(
        steps=3, seq_len=16, global_batch=8, optimizer=_optimizer())
    np.testing.assert_allclose([first, final],
                               [res.losses[0], res.losses[-1]], atol=1e-4)


@pytest.fixture(scope="module")
def joined_sequential():
    """The losses of one process stepping on two replicas' local batches
    joined (each replica's shard of the synthetic corpus)."""
    sess = api.load("stablelm-1.6b", smoke=True, device="cpu")
    run = RunConfig(model=sess.model, shape=ShapeConfig("t", "train", 16, 8),
                    mesh=MeshConfig(shape=(1, 1),
                                    axis_names=("data", "model")),
                    optimizer=_optimizer())
    tr = TransparentTrainer.from_bundle(run, sess.bundle, device="cpu")
    state = tr.init(0)
    shards = [iter(BatchIterator(synthetic_tokens(
        sess.model.vocab_size, 16, num_samples=8 * 64, seed=0, rank=r,
        world=2), 4, seed=0)) for r in range(2)]
    want = []
    for _ in range(3):
        local = [next(it) for it in shards]
        batch = {k: np.concatenate([b[k] for b in local]) for k in local[0]}
        state, m = tr.step(state, batch)
        want.append(float(m["loss"]))
    return want


def test_two_process_train_equals_the_joined_sequential_run(
        runs, joined_sequential):
    rc, text = runs["train_dp2"]
    assert rc == 0, text
    first, final = _losses(text)
    assert len(first) == len(final) == 2          # both ranks report
    want = joined_sequential
    np.testing.assert_allclose(first, [want[0]] * 2, atol=1e-4)
    np.testing.assert_allclose(final, [want[-1]] * 2, atol=1e-4)


def _streams(text):
    return [[int(t) for t in re.findall(r"\d+", m)]
            for m in re.findall(r"req \d+: \[([^\]]*)\]", text)]


@pytest.fixture(scope="module")
def one_process_streams():
    """``Session.serve`` on the serve launcher's prompts (lengths
    jittered from its --seed)."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 17, size=3)
    prompts = [list(rng.integers(0, 256, (int(n),))) for n in lengths]
    return api.load("qwen2.5-14b", smoke=True, device="cpu").serve(
        prompts, max_new=6, max_batch=4, max_seq_len=22)


def test_serve_prints_the_sessions_streams(runs, one_process_streams):
    rc, text = runs["serve"]
    assert rc == 0, text
    assert "served 3/3 requests" in text
    assert _streams(text) == one_process_streams


def test_model_axis_names_roadmap_item_10(runs, joined_sequential):
    """``--mesh 2x2``: four processes, a model axis of two (mesh
    transparency, ROADMAP item 10); every rank prints the losses of the
    joined sequential run."""
    rc, text = runs["mesh_2x2"]
    assert rc == 0, text
    first, final = _losses(text)
    assert len(first) == len(final) == 4          # every rank reports
    want = joined_sequential
    np.testing.assert_allclose(first, [want[0]] * 4, atol=1e-4)
    np.testing.assert_allclose(final, [want[-1]] * 4, atol=1e-4)


def test_meshed_serve_prints_the_one_process_streams(runs,
                                                     one_process_streams):
    rc, text = runs["serve_2x2"]
    assert rc == 0, text
    assert text.count("served 3/3 requests") == 1     # rank 0 prints
    assert _streams(text) == one_process_streams
