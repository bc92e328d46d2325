"""Public WKV6 entry point in the model layout (the JAX package's
``ops.wkv6``).

``use_kernel`` selects the hand-written CUDA kernel wrapper (which itself
takes the plain version for CPU tensors, see ``kernel.py``); False runs the
plain PyTorch version on any device.  The CUDA kernel takes the exact
sequence length, so there are no padded steps to keep out of ``s_last``.
"""
from __future__ import annotations

from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_kernel
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_model_ref


def wkv6(r, k, v, w, u, s0, *, use_kernel: bool = False):
    """Model layout: r,k,v,w [B,S,H,hd]; u [H,hd]; s0 [B,H,hd,hd].

    Returns (out [B,S,H,hd] fp32, s_last [B,H,hd,hd] fp32)."""
    if not use_kernel:
        return wkv6_model_ref(r, k, v, w, u, s0)
    f = lambda t: t.float().contiguous()
    return wkv6_kernel(f(r), f(k), f(v), f(w), f(u), f(s0))
