"""Public flash-attention entry point in the model layout ``[B, S, H, hd]``.

``use_kernel`` selects the hand-written CUDA kernel wrapper (which itself
takes the plain version for CPU tensors, see ``kernel.py``); False runs the
plain PyTorch version (``ref.attention_ref``) on any device.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def to_bhsd(x):
    """[B, S, H, hd] -> [B*H, S, hd] (contiguous: at B = 1 the reshape
    alone would return a strided view)."""
    B, S, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def from_bhsd(x, B: int):
    """[B*H, S, hd] -> [B, S, H, hd]."""
    BH, S, hd = x.shape
    return x.reshape(B, BH // B, S, hd).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    use_kernel: bool = False):
    """q: [B,S,H,hd]; k/v: [B,T,KV,hd] -> [B,S,H,hd] in q.dtype (the
    self-attention layout of ``repro_torch.models.attention``)."""
    B = q.shape[0]
    qf, kf, vf = to_bhsd(q), to_bhsd(k), to_bhsd(v)
    if use_kernel:
        out, _ = flash_attention_kernel(qf, kf, vf, causal=causal,
                                        window=window)
    else:
        out = attention_ref(qf, kf, vf, causal=causal, window=window)
    return from_bhsd(out, B)
