"""Wrapper of the hand-written CUDA RG-LRU scan kernel (K9).

``lru_scan_kernel`` launches ``csrc/lru_scan.cu``, the port of the TPU
kernel ``lru_scan_padded`` / ``_lru_kernel`` of the JAX package.  For
tensors on the CPU — and only there — it runs the plain version
(``ref.lru_scan_ref``).  For CUDA tensors it checks device, dtype, shape
and contiguity, allocates the output with ``torch.empty``, launches the
kernel on the current stream, raises if the launch was refused, and adds
one to its ``launches`` counter; there is no fallback.  The library builds
from the repo's sources on the first CUDA launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import check_tensor, lib_fn, raise_on
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def lru_scan_kernel(log_a, x):
    """K9.  log_a, x: [B, S, W] fp32 -> h [B, S, W] fp32 (h_{-1} = 0)."""
    if log_a.device.type == "cpu":
        return lru_scan_ref(log_a, x)
    if log_a.device.type != "cuda":
        raise ValueError(f"no lru-scan kernel for {log_a.device}")
    check_tensor(log_a, "log_a", torch.float32, log_a.device, 3)
    check_tensor(x, "x", torch.float32, log_a.device, 3)
    if x.shape != log_a.shape:
        raise ValueError(f"shape mismatch: log_a {tuple(log_a.shape)}, x "
                         f"{tuple(x.shape)}")
    B, S, W = x.shape
    h = torch.empty_like(x)
    fn = lib_fn("lru_scan", "lru_scan_launch", [_P] * 3 + [_I] * 3 + [_P])
    err = fn(log_a.data_ptr(), x.data_ptr(), h.data_ptr(), B, S, W,
             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "lru_scan")
    lru_scan_kernel.launches += 1
    return h


lru_scan_kernel.launches = 0
