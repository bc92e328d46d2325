"""Failure handling: straggler detection.

The port of ``StragglerMonitor`` from ``src/repro/checkpoint/failures.py``
(robust step-time outlier detection, median + k·MAD), which
``Session.train`` reports.  The supervised recovery loop
(``run_with_recovery``), checkpointing and elastic restore are not ported
yet — ROADMAP queue 1 item 5.
"""
from __future__ import annotations

from typing import List

import numpy as np


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
