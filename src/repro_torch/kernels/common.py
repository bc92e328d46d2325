"""Shared constants for the hand-written CUDA kernels and their plain
PyTorch versions."""
from __future__ import annotations

import numpy as np

# Large-negative mask value safe to exponentiate in fp32 (exp -> exactly 0).
# Finite on purpose: a fully masked row keeps finite scores, so the online
# softmax divides 0 by max(l, 1e-30) and emits 0 instead of NaN.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
