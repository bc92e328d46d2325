"""Parallel data readers — the paper's §III-F.

The port of ``src/repro/data/readers.py`` (numpy only, no jax, so the
module is a copy).

MaTEx's data readers are the ONE thing a user changes in their script
(Fig. 3): they read a dataset and transparently hand each rank its shard.
Formats mirror the paper's list — CSV, MNIST/CIFAR binary, NumPy (the
paper's parallel NetCDF is replaced by .npy memmap: no netCDF lib offline)
— plus a synthetic token stream for LM work.

Sharding semantics: deterministic strided partition by (rank, world):
sample i belongs to rank ``i % world``.  Every reader yields *local* batches
of ``global_batch // world``; the pipeline (pipeline.py) places this
rank's local batch on the trainer's device.
"""
from __future__ import annotations

import csv
import gzip
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class DataSet:
    """Paper-style container: training/validation arrays, rank-sharded."""
    training_data: np.ndarray
    training_labels: np.ndarray
    validation_data: Optional[np.ndarray] = None
    validation_labels: Optional[np.ndarray] = None


def _shard(arr: np.ndarray, rank: int, world: int) -> np.ndarray:
    return arr[rank::world]


# ---------------------------------------------------------------------------
# Synthetic LM tokens
# ---------------------------------------------------------------------------

def synthetic_tokens(vocab: int, seq_len: int, num_samples: int,
                     rank: int = 0, world: int = 1, seed: int = 0) -> DataSet:
    """Deterministic synthetic corpus: every rank derives its shard from the
    same global stream (so DP runs are reproducible and shards disjoint)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (num_samples, seq_len + 1), dtype=np.int32)
    toks = _shard(toks, rank, world)
    return DataSet(training_data=toks[:, :-1], training_labels=toks[:, 1:])


# ---------------------------------------------------------------------------
# NumPy (.npy / .npz) — the NetCDF stand-in
# ---------------------------------------------------------------------------

def numpy_reader(data_path: str, labels_path: Optional[str] = None,
                 rank: int = 0, world: int = 1, mmap: bool = True) -> DataSet:
    mode = "r" if mmap else None
    data = np.load(data_path, mmap_mode=mode)
    labels = np.load(labels_path, mmap_mode=mode) if labels_path else \
        np.zeros(len(data), np.int32)
    return DataSet(training_data=np.asarray(_shard(data, rank, world)),
                   training_labels=np.asarray(_shard(labels, rank, world)))


# ---------------------------------------------------------------------------
# CSV (last column = label, like MaTEx's csv reader)
# ---------------------------------------------------------------------------

def csv_reader(path: str, rank: int = 0, world: int = 1,
               has_header: bool = False, label_col: int = -1) -> DataSet:
    rows = []
    with open(path, newline="") as f:
        r = csv.reader(f)
        if has_header:
            next(r, None)
        for row in r:
            if row:
                rows.append([float(x) for x in row])
    arr = np.asarray(rows, np.float32)
    labels = arr[:, label_col].astype(np.int32)
    data = np.delete(arr, label_col % arr.shape[1], axis=1)
    return DataSet(training_data=_shard(data, rank, world),
                   training_labels=_shard(labels, rank, world))


# ---------------------------------------------------------------------------
# MNIST / CIFAR binary formats (paper-native)
# ---------------------------------------------------------------------------

def mnist_reader(images_path: str, labels_path: str,
                 rank: int = 0, world: int = 1) -> DataSet:
    """idx-ubyte format (gzip or raw)."""
    def _open(p):
        return gzip.open(p, "rb") if str(p).endswith(".gz") else open(p, "rb")

    with _open(images_path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad MNIST image magic {magic}")
        imgs = np.frombuffer(f.read(n * rows * cols), np.uint8)
        imgs = imgs.reshape(n, rows, cols, 1).astype(np.float32) / 255.0
    with _open(labels_path) as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad MNIST label magic {magic}")
        labels = np.frombuffer(f.read(n2), np.uint8).astype(np.int32)
    return DataSet(training_data=_shard(imgs, rank, world),
                   training_labels=_shard(labels, rank, world))


def cifar_reader(path: str, rank: int = 0, world: int = 1,
                 coarse: bool = False) -> DataSet:
    """CIFAR-10 binary: rows of [label, 3072 bytes RGB]."""
    raw = np.fromfile(path, np.uint8)
    row = 3073
    n = len(raw) // row
    raw = raw[:n * row].reshape(n, row)
    labels = raw[:, 0].astype(np.int32)
    imgs = raw[:, 1:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)
    imgs = imgs.astype(np.float32) / 255.0
    return DataSet(training_data=_shard(imgs, rank, world),
                   training_labels=_shard(labels, rank, world))


READERS = {
    "synthetic": synthetic_tokens,
    "numpy": numpy_reader,
    "csv": csv_reader,
    "mnist": mnist_reader,
    "cifar": cifar_reader,
}
