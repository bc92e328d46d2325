"""Plain PyTorch versions of the flash-attention kernel (K3).

``attention_ref`` copies ``src/repro/kernels/flash_attention/ref.py`` line
for line; ``attention_lse_ref`` gives the per-row logsumexp ``L`` the CUDA
kernel writes beside its output (the JAX package keeps it in VMEM scratch
only; the port's backward needs it).  Both materialize the full score
matrix — correctness only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def _masked_scores(q, k, causal: bool, window: int):
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    G = BH // BKV
    kf = torch.repeat_interleave(k, G, dim=0)
    s = torch.einsum("bqh,bkh->bqk", q.float(), kf.float()) * (hd ** -0.5)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return torch.where(mask[None], s, torch.full((), NEG_INF,
                                                 device=q.device))


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [BH, Sq, hd]; k/v: [BKV, Sk, hd] (GQA: BH = G * BKV).
    Returns [BH, Sq, hd] in q.dtype."""
    G = q.shape[0] // k.shape[0]
    vf = torch.repeat_interleave(v, G, dim=0)
    s = _masked_scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkh->bqh", p, vf.float())
    return out.to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = True, window: int = 0):
    """Row logsumexp ``L = m + log(max(l, 1e-30))`` of the masked, scaled
    scores, fp32 [BH, Sq] — what ``flash_vjp._fwd`` saves for the
    backward."""
    s = _masked_scores(q, k, causal, window)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return m + torch.log(torch.clamp(l, min=1e-30))
