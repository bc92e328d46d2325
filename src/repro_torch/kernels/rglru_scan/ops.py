"""Public RG-LRU scan entry point (the JAX package's ``ops.lru_scan``).

``use_kernel`` selects the hand-written CUDA kernel wrapper (which itself
takes the plain version for CPU tensors, see ``kernel.py``); False runs the
plain PyTorch version on any device.  The CUDA kernel takes exact shapes,
so nothing is padded: the result is the reference's unpadded one.
"""
from __future__ import annotations

from repro_torch.kernels.rglru_scan.kernel import lru_scan_kernel
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref


def lru_scan(log_a, gated, *, use_kernel: bool = False):
    """log_a, gated: [B, S, W] -> h [B, S, W] fp32."""
    if not use_kernel:
        return lru_scan_ref(log_a, gated)
    return lru_scan_kernel(log_a.float().contiguous(),
                           gated.float().contiguous())
