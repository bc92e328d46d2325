"""Shared constants for the hand-written CUDA kernels and their plain
PyTorch versions, the checks every kernel wrapper makes before it
launches, and the launch counts.

Every wrapper counts its launches (``launches``; the paged per-head
wrappers also ``launches_by`` page kind) through ``count_launch``.  Under
CUDA-graph capture (``capture_launches``, what ``serving/graphs.py``
wraps each capture in) nothing launches yet: the launches go to the
capture's tally, which ``add_launches`` adds to the counts at every replay
of the graph, so the counts stay the kernels' launches on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# Large-negative mask value safe to exponentiate in fp32 (exp -> exactly 0).
# Finite on purpose: a fully masked row keeps finite scores, so the online
# softmax divides 0 by max(l, 1e-30) and emits 0 instead of NaN.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)

#: dtype codes of the CUDA sources (DTYPE_F32 / DTYPE_BF16 in
#: csrc/paged_common.cuh)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lib_fn(name: str, fn: str, argtypes):
    """``fn`` of the library built from ``csrc/<name>.cu`` (built on first
    use), with its ctypes signature set; every entry point returns the
    ``cudaError_t`` of its launch."""
    from repro_torch.kernels import build
    f = getattr(build.load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def check_tensor(t: torch.Tensor, what: str, dtype, device, ndim: int):
    """Raise unless ``t`` has this device, dtype and rank and is contiguous."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor):
    """Raise when autograd would record through a forward-only kernel.

    A wrapper fills a ``torch.empty`` output through ctypes, so that output
    has no ``grad_fn``: launched on inputs that require grad, it would cut
    the graph and leave the parameters before it with zero gradient, and
    no error.  Train through the differentiable plain version instead (or
    K3's autograd Function, whose forward runs with grad mode off)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its inputs require grad, and its "
            "output would silently cut the autograd graph; train through "
            "the plain version (or call it under torch.no_grad())")


def raise_on(err: int, name: str):
    """Raise if a launch was refused (``err`` is its cudaError_t)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


class Capture:
    """What a CUDA-graph capture recorded of the kernel wrappers: the
    launches it holds (``(wrapper, kind) -> n``) and the scratch tensors
    its launches use beyond their arguments, which the graph keeps alive
    (a wrapper may replace its cached scratch later; the graph still
    points at the old one)."""

    def __init__(self):
        self.launches: Dict[Tuple[object, Optional[str]], int] = {}
        self.held: List[torch.Tensor] = []


#: the capture in progress (``capture_launches``), else None
_CAPTURE: Optional[Capture] = None


@contextlib.contextmanager
def capture_launches():
    """Route the wrappers' launch counts (and scratch) of a CUDA-graph
    capture into a ``Capture``, yielded; the counts are not touched."""
    global _CAPTURE
    outer, _CAPTURE = _CAPTURE, Capture()
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = outer


def _add(wrapper, kind: Optional[str], n: int) -> None:
    wrapper.launches += n
    if kind is not None:
        wrapper.launches_by[kind] = wrapper.launches_by.get(kind, 0) + n


def count_launch(wrapper, kind: Optional[str] = None) -> None:
    """One launch of ``wrapper``'s kernel (``kind``: its ``launches_by``
    key), or one more launch in the capture in progress."""
    if _CAPTURE is None:
        _add(wrapper, kind, 1)
    else:
        key = (wrapper, kind)
        _CAPTURE.launches[key] = _CAPTURE.launches.get(key, 0) + 1


def add_launches(launches: Dict[Tuple[object, Optional[str]], int]) -> None:
    """One replay of a captured graph: its launches (``Capture.launches``)."""
    for (wrapper, kind), n in launches.items():
        _add(wrapper, kind, n)


def hold_scratch(*tensors: torch.Tensor) -> None:
    """Scratch a launch uses beyond its arguments: kept alive by the graph
    being captured, if any."""
    if _CAPTURE is not None:
        _CAPTURE.held.extend(tensors)
