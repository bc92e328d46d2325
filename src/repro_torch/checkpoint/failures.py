"""Failure handling: straggler detection + supervised recovery loop.

The port of ``src/repro/checkpoint/failures.py``.  Two mechanisms the
paper's large-scale story needs (its §II-B names ULFM as the path to MPI
fault tolerance; this is the runtime policy layer):

  * ``StragglerMonitor`` — robust step-time outlier detection (median +
    k·MAD), which ``Session.train`` reports;
  * ``run_with_recovery`` — the supervision loop: run steps, checkpoint
    every N, on a failure rebuild the trainer (possibly smaller — the
    caller restarts with fewer processes, ``elastic.py``) and resume from
    the last durable checkpoint.  ``FaultInjector`` simulates a host loss
    deterministically for tests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np


class SimulatedFault(RuntimeError):
    pass


@dataclass
class FaultInjector:
    """Raises SimulatedFault at the given global steps (once each)."""
    fail_at_steps: Tuple[int, ...] = ()
    _fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFault(f"injected fault at step {step}")


class StragglerMonitor:
    """Flags steps (or ranks) whose duration exceeds median + k*MAD."""

    def __init__(self, k: float = 5.0, window: int = 50, warmup: int = 3):
        self.k = k
        self.window = window
        self.warmup = warmup
        self.times: List[float] = []
        self.flagged: List[int] = []

    def record(self, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(duration_s)
        hist = self.times[-self.window:]
        if len(self.times) <= self.warmup or len(hist) < 5:
            return False
        med = float(np.median(hist[:-1]))
        mad = float(np.median(np.abs(np.asarray(hist[:-1]) - med))) or 1e-9
        is_straggler = duration_s > med + self.k * mad
        if is_straggler:
            self.flagged.append(len(self.times) - 1)
        return is_straggler

    def summary(self):
        arr = np.asarray(self.times) if self.times else np.zeros(1)
        return {"steps": len(self.times), "mean_s": float(arr.mean()),
                "p50_s": float(np.median(arr)),
                "p95_s": float(np.percentile(arr, 95)),
                "stragglers": list(self.flagged)}


def run_with_recovery(*, make_trainer: Callable[[int], object],
                      data_iter_factory: Callable[[int], object],
                      ckpt_dir, total_steps: int, ckpt_every: int = 10,
                      injector: Optional[FaultInjector] = None,
                      max_restarts: int = 3, async_ckpt: bool = False):
    """Supervised training with checkpoint / restart.

    ``make_trainer(attempt)`` -> TransparentTrainer (attempt > 0 may be
    built for fewer replicas); ``data_iter_factory(start_step)`` -> an
    iterator of this rank's batches from global step ``start_step`` on.
    Checkpoints (the trainer's canonical view) every ``ckpt_every`` steps
    and at ``total_steps``; an async save is waited for before the next
    one, and before a restart reads the directory.  Returns (final state,
    history) with ``losses`` as (step, loss), ``restarts``,
    ``resume_steps`` and ``straggler_summary``.
    """
    from repro_torch.checkpoint.checkpoint import latest_step, save_checkpoint
    from repro_torch.checkpoint.elastic import restore_elastic
    history = {"losses": [], "restarts": 0, "resume_steps": []}
    attempt = 0
    monitor = StragglerMonitor()

    while attempt <= max_restarts:
        trainer = make_trainer(attempt)
        start = latest_step(ckpt_dir)
        if start is None:
            state = trainer.init(0)
            start = 0
        else:
            state, start = restore_elastic(ckpt_dir, trainer)
            history["resume_steps"].append(start)
        it = iter(data_iter_factory(start))
        step = start
        pending = None
        try:
            while step < total_steps:
                batch = next(it)
                if injector is not None:
                    injector.check(step)
                t0 = time.time()
                state, metrics = trainer.step(state, batch)
                loss = float(metrics["loss"])          # waits for the step
                monitor.record(time.time() - t0)
                step = int(metrics["step"])
                history["losses"].append((step, loss))
                if step % ckpt_every == 0 or step == total_steps:
                    if pending is not None:
                        pending.wait()
                    pending = save_checkpoint(
                        ckpt_dir, trainer.canonical_state(state), step,
                        blocking=not async_ckpt)
            if pending is not None:
                pending.wait()
            history["straggler_summary"] = monitor.summary()
            return state, history
        except SimulatedFault:
            if pending is not None:
                pending.wait()
            history["restarts"] += 1
            attempt += 1
    raise RuntimeError(f"exceeded {max_restarts} restarts")
