"""Plain PyTorch version of the RWKV-6 WKV kernel (K10).

``wkv6_ref`` copies ``src/repro/kernels/rwkv6_wkv/ref.py`` line for line
(layout [BH, S, hd]): the ``lax.scan`` over time is a loop over time
steps.  ``wkv6_model_ref`` is the same in the model layout.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0):
    """r,k,v,w: [BH, S, hd] fp32; u: [BH, hd]; s0: [BH, hd, hd].

    Returns (out [BH, S, hd], s_last [BH, hd, hd])."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    u = u.float()
    s = s0.float()
    outs = []
    for t in range(rf.shape[1]):
        r_t, k_t, v_t, w_t = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]          # [BH, hd, hd]
        outs.append(torch.einsum("bi,bij->bj", r_t, s + u[..., :, None] * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def to_bh(t):
    """[B, S, H, hd] -> [B*H, S, hd] (the reference kernel's layout)."""
    B, S, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hd)


def wkv6_model_ref(r, k, v, w, u, s0):
    """``wkv6_ref`` in the model layout: r,k,v,w [B,S,H,hd]; u [H,hd]; s0
    [B,H,hd,hd] -> (out [B,S,H,hd], s_last [B,H,hd,hd]) fp32."""
    B, S, H, hd = r.shape
    uf = u.float()[None].expand(B, H, hd).reshape(B * H, hd)
    out, s_last = wkv6_ref(to_bh(r), to_bh(k), to_bh(v), to_bh(w), uf,
                           s0.reshape(B * H, hd, hd))
    return (out.reshape(B, H, S, hd).transpose(1, 2),
            s_last.reshape(B, H, hd, hd))
