"""Checkpoint / restore with async save.

The port of ``src/repro/checkpoint/checkpoint.py``.  The paper defers
fault tolerance to ULFM (its §II-B) and notes that data parallelism
replicates the critical state for free; this is the mechanism that makes
that real:

  * atomic on-disk checkpoints (a ``.tmp_step_*`` directory, then a
    rename), one ``.npy`` per leaf and a JSON manifest (step, leaf count,
    paths, shapes, dtypes, time);
  * async save: the device-to-host copy runs on the caller's thread (the
    trainer updates its tensors in place right after), the file I/O on a
    daemon thread — training continues;
  * restore into any trainer's layout (``elastic.py`` re-splits ZeRO-1
    state saved at another data-parallel degree: the paper's §III-B
    argument).

In a ``torch.distributed`` process group rank 0 writes, and no rank goes
on before the write is durable.  Every rank calls ``save_checkpoint`` and
``SaveHandle.wait`` (a blocking save waits itself); each ends in a
collective that shares rank 0's outcome, so when its host copy or its
write fails every rank raises together instead of waiting on it.  The
tree saved is the trainer's canonical view
(``TransparentTrainer.canonical_state``, gathered across ranks first).

Trees are nested dicts and dataclasses (``TrainState``) of tensors or
arrays, flattened in the JAX pytree order: dataclass fields in order, dict
keys sorted, None holding no leaf.  A leaf whose dtype numpy cannot hold
(bf16) raises; it is never cast.

Layout:  <dir>/step_000000123/
             manifest.json
             leaf_00000.npy ...
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def leaf_items(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in the JAX pytree order; paths join
    field names and dict keys with "/"."""
    if tree is None:
        return []
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out.extend(leaf_items(getattr(tree, f.name), join(f.name)))
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaf_items(tree[k], join(k)))
        return out
    return [(prefix, tree)]


def unflatten_like(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in ``leaf_items``
    order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{f.name: build(getattr(t, f.name))
                                             for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _all_ok(error: Optional[BaseException]) -> bool:
    """Whether no rank passes an error: a collective over the world (so
    also a barrier) when a process group is up."""
    if not dist.is_initialized():
        return error is None
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([int(error is not None)], dtype=torch.int32,
                        device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return int(flag.item()) == 0


def _to_host(path: str, leaf) -> np.ndarray:
    """A host copy of one leaf (the caller may update the leaf in place
    right after)."""
    if isinstance(leaf, torch.Tensor):
        try:
            return leaf.detach().to("cpu", copy=True).numpy()
        except TypeError:
            raise TypeError(
                f"leaf {path!r} has dtype {leaf.dtype}, which numpy cannot "
                "hold: checkpoint the trainer's fp32 masters (a leaf is "
                "never cast silently)") from None
    return np.array(leaf, copy=True)


class SaveHandle:
    """A save in flight.  ``wait()`` returns once the checkpoint is
    durable, or raises if the write failed (in a process group: on every
    rank, and every rank must call it).  ``copy_s`` is the caller thread's
    device-to-host time, ``write_s`` the file I/O's, ``bytes`` the leaves'
    size (rank 0)."""

    def __init__(self, directory: Path, step: int):
        self.directory = directory
        self.step = step
        self.copy_s = 0.0
        self.write_s = 0.0
        self.bytes = 0
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._ok: Optional[bool] = None     # every rank's, once agreed

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not self._done.wait(timeout):
            return False
        if self._ok is None:
            self._ok = _all_ok(self._error)
        if not self._ok:
            where = "" if self._error is not None else " on rank 0"
            raise RuntimeError(f"checkpoint of step {self.step} failed"
                               f"{where}") from self._error
        return True


def save_checkpoint(directory, state, step: int, *, blocking: bool = True,
                    keep: int = 3) -> SaveHandle:
    """Checkpoint a tree of tensors / arrays as ``step``.  Returns a
    SaveHandle; call ``.wait()`` (or save with blocking=True) before
    relying on durability.  ``keep`` newest checkpoints stay (0: all)."""
    directory = Path(directory)
    handle = SaveHandle(directory, step)
    error = None
    if _rank() == 0:                    # rank 0 writes the canonical view
        try:
            directory.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            items = leaf_items(state)
            host = [_to_host(p, leaf) for p, leaf in items]
            handle.copy_s = time.perf_counter() - t0
        except Exception as e:          # raised below, on every rank
            error = e
    if not _all_ok(error):
        if error is not None:
            raise error
        raise RuntimeError(f"checkpoint of step {step} failed on rank 0")
    if _rank() != 0:
        handle._done.set()
        if blocking:
            handle.wait()
        return handle
    handle.bytes = sum(x.nbytes for x in host)
    manifest = {
        "step": int(step),
        "n_leaves": len(host),
        "paths": [p for p, _ in items],
        "shapes": [list(x.shape) for x in host],
        "dtypes": [str(x.dtype) for x in host],
        "time": time.time(),
    }

    def _write():
        try:
            t1 = time.perf_counter()
            tmp = directory / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, arr in enumerate(host):
                np.save(tmp / f"leaf_{i:05d}.npy", arr)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = directory / f"step_{step:09d}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            _prune(directory, keep)
            handle.write_s = time.perf_counter() - t1
        except BaseException as e:       # surfaced by wait()
            handle._error = e
        finally:
            host.clear()
            handle._done.set()

    if blocking:
        _write()
        handle.wait()
    else:
        threading.Thread(target=_write, daemon=True).start()
    return handle


def _prune(directory: Path, keep: int):
    steps = sorted(directory.glob("step_*"))
    for old in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    steps = sorted(directory.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def read_manifest(directory, step: int) -> dict:
    return json.loads((Path(directory) / f"step_{step:09d}"
                       / "manifest.json").read_text())


def load_leaves(directory, step: int) -> List[np.ndarray]:
    """The saved leaves of ``step`` as numpy arrays, in order."""
    d = Path(directory) / f"step_{step:09d}"
    n = read_manifest(directory, step)["n_leaves"]
    return [np.load(d / f"leaf_{i:05d}.npy") for i in range(n)]


def restore_checkpoint(directory, like, *, step: Optional[int] = None):
    """Restore into the structure of ``like`` (a tree of tensors or meta
    tensors, e.g. ``TransparentTrainer.state_structs()``); leaf shapes
    must match.  Returns (tree of CPU tensors, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    like_leaves = [leaf for _, leaf in leaf_items(like)]
    host = load_leaves(directory, step)
    if len(host) != len(like_leaves):
        raise ValueError(f"checkpoint has {len(host)} leaves, the target "
                         f"{len(like_leaves)}")
    for (path, ref), arr in zip(leaf_items(like), host):
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {path!r}: saved {tuple(arr.shape)}, "
                             f"target {tuple(ref.shape)}")
    return unflatten_like(like, [torch.from_numpy(a) for a in host]), step
