"""The port's examples (``repro_torch.examples``) on the CPU.

* ``serve_lm`` in process: its streams are the JAX example's — the JAX
  ``Session.serve`` of the same prompts on the same weights (the port
  session takes the JAX smoke weights through ``from_jax_params``; the
  example itself draws its own).
* ``quickstart`` as published: ``mesh="4x2"``, 8 gloo processes under
  ``torch.distributed.run`` (a subprocess with its own timeout).  Its
  losses must equal the JAX package's sequential steps
  (``torch_parity.jax_sequential_curve``: one device, no mesh) from the
  same init weights on the same global batches: each of the 4
  data-parallel replicas reads its own shard of the synthetic stream and
  shuffles it, so the reference is fed the 4 replicas' local batches side
  by side (the script's own ``--mesh 1`` run reads the unsharded stream,
  another curve).  The init weights are the port's seed-0 init, carried
  across to JAX leaf for leaf (the two share every leaf's layout).
  Tolerance 5e-4 absolute on the loss, as the mesh tests': the 2-way
  tensor-parallel sums and the 4-way gradient mean add in another order.
* ``elastic_restart`` as published: 8 processes lose half at step 17 and
  the 4 left resume from the step-10 checkpoint; every step, the first
  pass's and the resumed run's, equals the JAX sequential curve on the
  same weights and batches.
* The three smoke-config examples refuse ``--device cuda``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import get_config as jax_get_config
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.convert import from_jax_params
from repro_torch.core.transparent import TransparentTrainer
from repro_torch.data.pipeline import make_input_pipeline
from repro_torch.data.readers import synthetic_tokens
from repro_torch.examples import (elastic_restart, quickstart, serve_lm,
                                  SMOKE_ON_CUDA)
from repro_torch.models import registry
from torch_parity import jax_sequential_curve

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
ATOL = 5e-4


def test_serve_lm_streams_equal_the_jax_session(monkeypatch, capsys):
    jsess = jax_api.load("qwen2.5-14b", smoke=True, seed=0)
    weights = from_jax_params(jax.tree.map(np.asarray, jsess.params))
    real_load = api.load

    def load(*a, **kw):
        sess = real_load(*a, **kw)
        sess.set_params(weights)
        return sess
    monkeypatch.setattr(api, "load", load)
    prompts, outs = serve_lm.main([])
    assert "served 6/6 requests" in capsys.readouterr().out
    assert outs == jsess.serve(prompts, max_new=8, max_batch=3)


def _init_weights(cfg, seq_len, global_batch, lr):
    """The port's seed-0 init (what every process of the examples starts
    from: the one-device init equals the meshed one's shards), as the
    JAX tree the reference steps."""
    run = RunConfig(model=cfg, shape=ShapeConfig("api", "train", seq_len,
                                                 global_batch),
                    mesh=MeshConfig(shape=(1, 1),
                                    axis_names=("data", "model")),
                    optimizer=OptimizerConfig(name="adam", lr=lr))
    tr = TransparentTrainer.from_bundle(run, registry.build(cfg),
                                        device="cpu")
    return jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                        tr.init(0).params)


def _jax_curve(batches, lr, seq_len, global_batch):
    """The JAX package's sequential steps (Adam at ``lr``, the defaults of
    both packages' OptimizerConfig) from the port's init weights."""
    cfg = get_config("stablelm-1.6b", smoke=True)
    losses, _ = jax_sequential_curve(
        jax_get_config("stablelm-1.6b", smoke=True),
        _init_weights(cfg, seq_len, global_batch, lr),
        [{k: np.asarray(v) for k, v in b.items()} for b in batches],
        JaxOptimizerConfig(name="adam", lr=lr))
    return losses


def _one_device_curve(steps=30, seq_len=32, global_batch=16, dp=4):
    """The quickstart's training as the JAX package's sequential steps,
    fed the 4 replicas' local batches side by side (Session.train's
    defaults: Adam lr 1e-3, seed 0)."""
    cfg = get_config("stablelm-1.6b", smoke=True)
    streams = []
    for r in range(dp):
        data = synthetic_tokens(cfg.vocab_size, seq_len,
                                num_samples=global_batch * 64, seed=0,
                                rank=r, world=dp)
        streams.append(make_input_pipeline(data, global_batch, "cpu",
                                           world=dp, seed=0))
    batches = []
    try:
        for _ in range(steps):
            parts = [next(it) for it, _ in streams]
            batches.append({k: torch.cat([p[k] for p in parts])
                            for k in parts[0]})
    finally:
        for _, pf in streams:
            pf.close()
    return _jax_curve(batches, 1e-3, seq_len, global_batch)


def test_quickstart_on_4x2_equals_one_device():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.examples.quickstart"],
        capture_output=True, text=True, timeout=TIMEOUT, env=env,
        cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-6000:]
    assert "trained 30 steps" in out.stdout
    assert len(re.findall(r"^  req \d: \[", out.stdout, re.M)) == 3
    got = eval(re.search(r"^losses: (\[.*\])$", out.stdout, re.M).group(1))
    want = _one_device_curve()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert want[-1] < want[0]


def test_elastic_restart_8_to_4_processes(tmp_path):
    """``elastic_restart`` as published: 8 processes (4x2) lose half at step
    17 and resume on 4 (2x2) from the step-10 checkpoint.  Both passes
    see the script's global batches in order, so every logged step —
    1-17 of the first pass, 11-30 of the resumed run — equals the JAX
    sequential curve from the same init (within 5e-4: 4-way and 2-way
    gradient means and 2-way tensor-parallel sums in another order)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m",
         "repro_torch.examples.elastic_restart",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=TIMEOUT, env=env,
        cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-6000:]
    assert "restarts: 1  resumed at steps: [10]" in out.stdout
    assert out.stdout.count("replica lost: leaving") == 4
    curve = [(int(s), float(l)) for s, l in re.findall(
        r"^  step +(\d+)  loss ([\d.]+)", out.stdout, re.M)]
    first, resumed = curve[:17], curve[17:]
    assert [s for s, _ in first] == list(range(1, 18))
    assert [s for s, _ in resumed] == list(range(11, 31))
    want = _jax_curve(_elastic_batches(), 1e-2, 16, 8)
    for s, loss in first + resumed:
        assert abs(loss - want[s - 1]) <= ATOL, (s, loss, want[s - 1])


def _elastic_batches():
    """``elastic_restart``'s global batches (its rng(0) draws), in order."""
    cfg = get_config("stablelm-1.6b", smoke=True)
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (8, 16)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (8, 16)).astype(
                 np.int32)} for _ in range(30)]


@pytest.mark.parametrize("example", [quickstart, serve_lm, elastic_restart],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_smoke_examples_refuse_cuda(example):
    """A smoke-config example asked for the card stops with the reason
    (head_dim 16 is not a kernel shape) before it loads anything; there
    is no fallback to the CPU."""
    with pytest.raises(SystemExit, match="head_dim 16") as e:
        example.main(["--device", "cuda"])
    assert SMOKE_ON_CUDA in str(e.value)
