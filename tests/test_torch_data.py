"""The port's data readers and input pipeline against the JAX package's:
rank shards and batches are equal array for array (exact)."""
import csv

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.data import readers as jax_readers
from repro_torch.data import pipeline as port_pipeline
from repro_torch.data import readers as port_readers


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 4), (3, 4)])
def test_synthetic_token_shards_equal(rank, world):
    kw = dict(vocab=97, seq_len=12, num_samples=40, rank=rank, world=world,
              seed=7)
    want = jax_readers.synthetic_tokens(**kw)
    got = port_readers.synthetic_tokens(**kw)
    np.testing.assert_array_equal(got.training_data, want.training_data)
    np.testing.assert_array_equal(got.training_labels, want.training_labels)


def test_pipeline_batches_equal_across_epochs():
    """Shuffle (``default_rng(seed + epoch)``), drop-last batching and the
    epoch wrap give the same batches; the port's land on the device as
    tensors."""
    ds = jax_readers.synthetic_tokens(50, 8, num_samples=21, seed=3)
    mesh = jax.make_mesh((1,), ("data",))
    jit, jpf = jax_pipeline.make_input_pipeline(ds, 4, mesh, ("data",),
                                                seed=11)
    pds = port_readers.DataSet(ds.training_data, ds.training_labels)
    pit, ppf = port_pipeline.make_input_pipeline(pds, 4, "cpu", seed=11)
    try:
        for _ in range(12):                     # 5 batches an epoch
            jb, pb = next(jit), next(pit)
            assert set(jb) == set(pb) == {"tokens", "labels"}
            for k in jb:
                assert isinstance(pb[k], torch.Tensor)
                assert pb[k].device.type == "cpu"
                np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
    finally:
        jpf.close()
        ppf.close()


def test_pipeline_splits_the_global_batch_over_ranks():
    ds = port_readers.synthetic_tokens(50, 8, num_samples=32, rank=1,
                                       world=4, seed=0)
    it, pf = port_pipeline.make_input_pipeline(ds, 8, "cpu", world=4)
    try:
        assert next(it)["tokens"].shape == (2, 8)
    finally:
        pf.close()


def test_numpy_and_csv_readers_equal(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(10, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 10).astype(np.int32)
    np.save(tmp_path / "x.npy", data)
    np.save(tmp_path / "y.npy", labels)
    with open(tmp_path / "d.csv", "w", newline="") as f:
        csv.writer(f).writerows(
            [[*map(float, r), int(y)] for r, y in zip(data, labels)])
    for rank, world in ((0, 1), (1, 3)):
        pairs = [
            (jax_readers.numpy_reader(str(tmp_path / "x.npy"),
                                      str(tmp_path / "y.npy"), rank, world),
             port_readers.numpy_reader(str(tmp_path / "x.npy"),
                                       str(tmp_path / "y.npy"), rank, world)),
            (jax_readers.csv_reader(str(tmp_path / "d.csv"), rank, world),
             port_readers.csv_reader(str(tmp_path / "d.csv"), rank, world))]
        for want, got in pairs:
            np.testing.assert_array_equal(got.training_data,
                                          want.training_data)
            np.testing.assert_array_equal(got.training_labels,
                                          want.training_labels)
