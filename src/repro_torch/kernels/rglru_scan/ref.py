"""Plain PyTorch version of the RG-LRU scan kernel (K9).

``lru_scan_ref`` copies ``src/repro/kernels/rglru_scan/ref.py`` line for
line: the ``lax.scan`` over time is a loop over time steps.
"""
from __future__ import annotations

import torch


def lru_scan_ref(log_a, x):
    """h_t = exp(log_a_t) * h_{t-1} + x_t, h_{-1} = 0.

    log_a, x: [B, S, W] -> [B, S, W] fp32."""
    la = log_a.float()
    xt = x.float()
    h = torch.zeros_like(xt[:, 0])
    hs = []
    for t in range(xt.shape[1]):
        h = torch.exp(la[:, t]) * h + xt[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
