"""Wrapper of the hand-written CUDA RWKV-6 WKV kernel (K10).

``wkv6_kernel`` launches ``csrc/wkv6.cu``, the port of the TPU kernel
``wkv6_padded`` / ``_wkv_kernel`` of the JAX package, in the model layout
(the CUDA kernel reads [B, S, H, hd] rows directly): every (b, h)'s state
columns split over blocks of 16, each column's rows over threads of 8
rows, the steps' rows staged into shared memory 32 steps at a time.  For tensors on the
CPU — and only there — it runs the plain version (``ref.wkv6_model_ref``).  For CUDA tensors it checks device, dtype, shape
and contiguity, allocates the outputs with ``torch.empty``, launches the
kernel on the current stream, raises if the launch was refused, and adds
one to its ``launches`` counter; there is no fallback.  It has no
backward, so it raises on inputs that require grad under grad mode
(``common.refuse_grad``).  The library builds
from the repo's sources on the first CUDA launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (check_tensor, count_launch, lib_fn,
                                        raise_on, refuse_grad)
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_model_ref

#: head sizes the CUDA kernel is instantiated for
HEAD_SIZES = (16, 32, 64)
#: state columns a block of the CUDA kernel holds, state rows a thread
#: holds (a column's rows split over hd / 8 threads) and steps a staged
#: chunk (WKV_COLS, WKV_ROWS and WKV_STEPS in csrc/wkv6.cu)
WKV_COLUMNS, WKV_ROWS, WKV_CHUNK = 16, 8, 32

_P = ctypes.c_void_p
_I = ctypes.c_int


def wkv6_kernel(r, k, v, w, u, s0):
    """K10.  r, k, v, w: [B, S, H, hd] fp32; u: [H, hd] fp32; s0:
    [B, H, hd, hd] fp32.  Returns (out [B, S, H, hd], s_last
    [B, H, hd, hd]) fp32."""
    B, S, H, hd = r.shape
    if r.device.type == "cpu":
        return wkv6_model_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for {r.device}")
    refuse_grad("wkv6 (K10)", r, k, v, w, u, s0)
    dev = r.device
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        check_tensor(t, name, torch.float32, dev, 4)
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(r.shape)}")
    check_tensor(u, "u", torch.float32, dev, 2)
    check_tensor(s0, "s0", torch.float32, dev, 4)
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)} / s0 {tuple(s0.shape)} do not "
                         f"fit r {tuple(r.shape)}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"head size {hd} not in the CUDA kernel's "
                         f"{HEAD_SIZES}")
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        if t.data_ptr() % 16:             # staged by 16-byte copies
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(r)
    s_last = torch.empty_like(s0)
    fn = lib_fn("wkv6", "wkv6_launch", [_P] * 8 + [_I] * 4 + [_P])
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_last.data_ptr(),
             B, S, H, hd, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "wkv6")
    count_launch(wkv6_kernel)
    return out, s_last


wkv6_kernel.launches = 0
