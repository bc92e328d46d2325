"""Wrapper of the hand-written CUDA flash-attention kernel (K3).

``flash_attention_kernel`` launches ``csrc/flash_attention.cu``, the port
of the TPU kernel ``flash_attention_bhsd`` / ``_flash_kernel`` of the JAX
package, and returns the output together with the row logsumexp ``L``
that the training backward needs.

For tensors on the CPU — and only there — it runs the plain PyTorch
versions (``ref.attention_ref``, ``ref.attention_lse_ref``).  For CUDA
tensors it checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches the kernel on the current stream,
raises if the launch was refused, and adds one to its ``launches``
counter; there is no fallback.  Training reaches it only through the
autograd Function of ``models/flash_vjp.py`` (whose forward runs with
grad mode off); called directly on inputs that require grad under grad
mode it raises (``common.refuse_grad``).  The library builds from the repo's sources
on the first CUDA launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (KERNEL_DTYPES, check_tensor,
                                        count_launch, lib_fn, raise_on,
                                        refuse_grad)
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)

#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0):
    """K3.  q: [BH, Sq, hd]; k/v: [BKV, Sk, hd] with BH % BKV == 0 (query
    row bh reads kv row bh // G).  Returns (out [BH, Sq, hd] in q.dtype,
    L [BH, Sq] fp32)."""
    BH, Sq, hd = q.shape
    if q.device.type == "cpu":
        return (attention_ref(q, k, v, causal=causal, window=window),
                attention_lse_ref(q, k, causal=causal, window=window))
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    refuse_grad("flash_attention (K3)", q, k, v)
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in "
                         f"{sorted(map(str, KERNEL_DTYPES))}")
    check_tensor(q, "q", q.dtype, q.device, 3)
    check_tensor(k, "k", q.dtype, q.device, 3)
    check_tensor(v, "v", q.dtype, q.device, 3)
    BKV, Sk, hd_k = k.shape
    if tuple(v.shape) != tuple(k.shape) or hd_k != hd or BH % BKV:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the CUDA kernel's "
                         f"{HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    fn = lib_fn("flash_attention", "flash_attention_launch",
                [_P] * 5 + [_I] * 8 + [_P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), BH, BKV, Sq, Sk, hd, int(causal), int(window),
             KERNEL_DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_attention")
    count_launch(flash_attention_kernel)
    return out, lse


flash_attention_kernel.launches = 0
