"""Wrapper of the hand-written CUDA RG-LRU scan kernel (K9).

``lru_scan_kernel`` launches ``csrc/lru_scan.cu``, the port of the TPU
kernel ``lru_scan_padded`` / ``_lru_kernel`` of the JAX package: a chunked
scan in one launch, a block of 32 channels walking the sequence in
super-chunks, each split over the block's warps in runs, the split picked
by ``lru_scan_splits`` from the shapes alone.  For tensors on the CPU —
and only there — it runs the plain version (``ref.lru_scan_ref``).  For
CUDA tensors it checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches the kernel on the current stream,
raises if the launch was refused, and adds one to its ``launches``
counter; there is no fallback.  It has no backward, so it raises on
inputs that require grad under grad mode (``common.refuse_grad``).  The library builds from the repo's
sources on the first CUDA launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.common import (check_tensor, count_launch, lib_fn,
                                        raise_on, refuse_grad)
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

#: channels a block (one 128-byte row of fp32 a step; LRU_CH in
#: csrc/lru_scan.cu) and the most warps a block (LRU_MAX_WARPS)
LRU_CHANNELS, LRU_MAX_WARPS = 32, 16
#: the dynamic shared memory a block may take on Hopper (227 KB)
LRU_SMEM_MAX = 227 * 1024
#: the split's shape rules (the card's forced-split sweep, PERF.md): a
#: warp's run gets at least LRU_WARP_MIN steps before the block takes
#: another warp, and at most LRU_WARP_MAX steps a super-chunk (longer
#: sequences stream through double-buffered super-chunks)
LRU_WARP_MIN, LRU_WARP_MAX = 8, 17


class LruSplit(NamedTuple):
    """How one K9 launch cuts its work: a block of ``LRU_CHANNELS``
    channels and ``warps`` warps walks the sequence in super-chunks of
    ``warps * steps`` steps, warp w holding the w-th run of ``steps``."""
    warps: int
    steps: int


def lru_scan_chunks(S: int, split: LruSplit) -> int:
    """Super-chunks of a block's walk over ``S`` steps."""
    return -(-S // (split.warps * split.steps))


def lru_scan_smem(S: int, split: LruSplit) -> int:
    """The launch's dynamic shared memory a block (``lru_smem_bytes``):
    the staged log_a and x rows, double-buffered when the walk has more
    than one super-chunk, and the warps' totals, double-buffered."""
    bufs = min(lru_scan_chunks(S, split), 2)
    return 4 * LRU_CHANNELS * split.warps * (2 * bufs * split.steps + 4)


def lru_scan_splits(S: int, *, chunks=None, warps=None) -> LruSplit:
    """The K9 split over ``S`` steps: warps until a run is down to
    ``LRU_WARP_MIN`` steps (at most ``LRU_MAX_WARPS``); runs over
    ``LRU_WARP_MAX`` steps walk super-chunks, the steps balanced over
    them.  ``chunks`` (super-chunks) and ``warps`` force those counts
    (the card's forced-split checks and sweeps).  Shapes only: no host
    sync; batch and width only add blocks."""
    if warps is None:
        warps = max(1, min(LRU_MAX_WARPS, -(-S // LRU_WARP_MIN)))
    if chunks is None:
        chunks = -(-S // (warps * LRU_WARP_MAX))
    return LruSplit(warps, -(-S // (warps * chunks)))


def lru_scan_kernel(log_a, x, *, _splits: LruSplit | None = None):
    """K9.  log_a, x: [B, S, W] fp32 -> h [B, S, W] fp32 (h_{-1} = 0).
    ``_splits`` overrides ``lru_scan_splits`` (the tests that hold forced
    splits against the plain version)."""
    if log_a.device.type == "cpu":
        return lru_scan_ref(log_a, x)
    if log_a.device.type != "cuda":
        raise ValueError(f"no lru-scan kernel for {log_a.device}")
    refuse_grad("lru_scan (K9)", log_a, x)
    check_tensor(log_a, "log_a", torch.float32, log_a.device, 3)
    check_tensor(x, "x", torch.float32, log_a.device, 3)
    if x.shape != log_a.shape:
        raise ValueError(f"shape mismatch: log_a {tuple(log_a.shape)}, x "
                         f"{tuple(x.shape)}")
    B, S, W = x.shape
    split = _splits or lru_scan_splits(S)
    if (not 1 <= split.warps <= LRU_MAX_WARPS or split.steps < 1
            or lru_scan_smem(S, split) > LRU_SMEM_MAX):
        raise ValueError(f"bad split {split}")
    h = torch.empty_like(x)
    fn = lib_fn("lru_scan", "lru_scan_launch", [_P] * 3 + [_I] * 5 + [_P])
    err = fn(log_a.data_ptr(), x.data_ptr(), h.data_ptr(), B, S, W,
             split.warps, split.steps,
             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "lru_scan")
    count_launch(lru_scan_kernel)
    return h


lru_scan_kernel.launches = 0
