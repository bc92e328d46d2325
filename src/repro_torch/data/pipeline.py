"""Input pipeline: rank-sharded iteration + background prefetch + batches
on the trainer's device.

The port of ``src/repro/data/pipeline.py``.  Each data-parallel process
reads its own shard (the readers shard by rank) and feeds its local batch
of ``global_batch // world`` rows; where the JAX package assembled global
sharded arrays (``device_put_global``), the port places the local batch on
the trainer's device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data.readers import DataSet


class BatchIterator:
    """Deterministic epoch shuffling + drop-last batching over a DataSet."""

    def __init__(self, ds: DataSet, batch: int, seed: int = 0,
                 shuffle: bool = True, label_key: str = "labels",
                 data_key: str = "tokens"):
        self.ds = ds
        self.batch = batch
        self.seed = seed
        self.shuffle = shuffle
        self.data_key = data_key
        self.label_key = label_key
        self.epoch = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds.training_data)
        while True:
            idx = np.arange(n)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self.epoch)
                rng.shuffle(idx)
            for i in range(0, n - self.batch + 1, self.batch):
                sel = idx[i:i + self.batch]
                yield {self.data_key: self.ds.training_data[sel],
                       self.label_key: self.ds.training_labels[sel]}
            self.epoch += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded), hiding host read latency
    behind device compute — the I/O consideration of the paper's §III-F.
    The thread only reads host arrays; device copies stay on the caller's
    thread."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, args=(iter(it),),
                                       daemon=True)
        self.thread.start()

    def _fill(self, it):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device`` (this rank's local batch)."""
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for k, x in batch.items()}


def make_input_pipeline(ds: DataSet, global_batch: int, device, *,
                        world: Optional[int] = None, seed: int = 0,
                        prefetch: int = 2, data_key: str = "tokens",
                        label_key: str = "labels"):
    """Full pipeline: shuffle -> batch -> prefetch -> device tensors.

    ``ds`` is this rank's shard; ``world`` (default: the process group's
    size, 1 without one) splits ``global_batch`` into local batches.  On a
    mesh with a model axis ``world`` is the data-parallel degree
    (``TransparentTrainer.dp``): each data-parallel rank feeds its share,
    and the model ranks of one replica feed the same rows (their shard
    of the data is the replica's, ``TransparentTrainer.rank``).
    Returns (iterator of device batches, prefetcher — close it when done).
    """
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    it = BatchIterator(ds, global_batch // world, seed=seed,
                       data_key=data_key, label_key=label_key)
    pf = Prefetcher(iter(it), depth=prefetch)

    def gen():
        for host_batch in pf:
            yield to_device(host_batch, device)

    return gen(), pf
