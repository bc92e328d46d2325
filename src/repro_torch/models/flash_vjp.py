"""Flash-attention forward/backward with O(S) residuals, as one autograd
Function.

The port of ``src/repro/models/flash_vjp.py``: save only (O, L =
logsumexp) per row, recompute the probabilities block by block in the
backward, and accumulate dq / dk / dv over the blocks — no stacked
probability tensors.  ``_fwd`` and ``_bwd`` are the JAX package's double
scans as Python loops over query and key blocks, in fp32.

``FlashAttention`` joins them with kernel K3: its forward runs the
hand-written CUDA kernel on a CUDA tensor when ``use_kernel`` is set (the
kernel writes L beside O) and ``_fwd`` otherwise; its backward is always
``_bwd`` (the JAX package has no backward kernel; a CUDA backward is later
work).  With the kernel, the O saved for the backward is the kernel's
output in the compute dtype, where ``_fwd`` saves it in fp32.

Key blocks that are masked for every query of a block (above the causal
diagonal, or outside the window) are skipped in both directions.  That
changes no value: their probabilities are exactly 0 once a row has seen a
valid key, and a block before a row's first valid key is wiped by the
correction factor exp(NEG_INF - m) = 0 (forward) or contributes
exp(NEG_INF - L) = 0 (backward).

Layout [B, S, KV, G, hd] internally; ``flash_attention_vjp`` takes the
model layout and pads S to the tile size by the JAX package's rule.  The
mask keeps keys below the unpadded length ``n`` (the JAX package masks
below the padded one, which only its causal callers reach); K3 runs on
the ``n`` real rows, so a bidirectional (``causal=False``) encoder never
attends a padding key.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import from_bhsd, to_bhsd


def _mask(q0, k0, bq, bk, n, causal, window, device):
    qp = q0 + torch.arange(bq, device=device)[:, None]
    kp = k0 + torch.arange(bk, device=device)[None, :]
    m = kp < n
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    return m


def _skip(q0, k0, bq, bk, causal, window) -> bool:
    """True when key block [k0, k0+bk) is masked for every query of
    [q0, q0+bq) (the TPU kernel's grid-level skip)."""
    if causal and k0 > q0 + bq - 1:
        return True
    return bool(window) and k0 + bk - 1 <= q0 - window


def _fwd(q, k, v, causal, window, bq, bk, n=None):
    """Keys below ``n`` only (default: all S).  Returns (out fp32
    [B,S,KV,G,hd], L [B,S,KV,G])."""
    B, S, KV, G, hd = q.shape
    n = S if n is None else n
    nq, nk = S // bq, S // bk
    scale = hd ** -0.5
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)
    outs, lses = [], []
    for iq in range(nq):
        qblk = q[:, iq * bq:(iq + 1) * bq].float()            # [B,bq,KV,G,hd]
        m = torch.full((B, KV, G, bq), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, bq), device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), device=dev)
        for ik in range(nk):
            if _skip(iq * bq, ik * bk, bq, bk, causal, window):
                continue
            kblk = k[:, ik * bk:(ik + 1) * bk]
            vblk = v[:, ik * bk:(ik + 1) * bk]
            s = torch.einsum("bqkgh,btkh->bkgqt", qblk, kblk.float()) * scale
            msk = _mask(iq * bq, ik * bk, bq, bk, n, causal, window, dev)
            s = torch.where(msk, s, neg)
            m_n = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_n)
            p = torch.exp(s - m_n[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p.to(vblk.dtype).float(), vblk.float())
            m = m_n
        lc = torch.clamp(l, min=1e-30)
        outs.append((acc / lc[..., None]).permute(0, 3, 1, 2, 4))
        lses.append((m + torch.log(lc)).permute(0, 3, 1, 2))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _bwd(res, do, causal, window, bq, bk, n=None):
    q, k, v, o, L = res
    B, S, KV, G, hd = q.shape
    n = S if n is None else n
    nq, nk = S // bq, S // bk
    scale = hd ** -0.5
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)
    do = do.float()
    # D_i = rowsum(dO * O)
    D = torch.sum(do * o.float(), dim=-1)                     # [B,S,KV,G]
    dq = torch.zeros((B, S, KV, G, hd), device=dev)
    dk = torch.zeros((B, S, KV, hd), device=dev)
    dv = torch.zeros((B, S, KV, hd), device=dev)
    for ik in range(nk):
        ks = slice(ik * bk, (ik + 1) * bk)
        kblk, vblk = k[:, ks].float(), v[:, ks].float()
        for iq in range(nq):
            if _skip(iq * bq, ik * bk, bq, bk, causal, window):
                continue
            qs = slice(iq * bq, (iq + 1) * bq)
            qblk, doblk = q[:, qs].float(), do[:, qs]
            Lblk = L[:, qs].permute(0, 2, 3, 1)[..., None]     # [B,KV,G,bq,1]
            Dblk = D[:, qs].permute(0, 2, 3, 1)[..., None]
            s = torch.einsum("bqkgh,btkh->bkgqt", qblk, kblk) * scale
            msk = _mask(iq * bq, ik * bk, bq, bk, n, causal, window, dev)
            s = torch.where(msk, s, neg)
            p = torch.exp(s - Lblk)                            # [B,KV,G,bq,bk]
            dov = torch.einsum("bqkgh,btkh->bkgqt", doblk, vblk)
            ds = p * (dov - Dblk) * scale
            dq[:, qs] += torch.einsum("bkgqt,btkh->bqkgh", ds, kblk)
            dk[:, ks] += torch.einsum("bkgqt,bqkgh->btkh", ds, qblk)
            dv[:, ks] += torch.einsum("bkgqt,bqkgh->btkh", p, doblk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_fwd(q, k, v, causal, window):
    """K3 on [B,S,KV,G,hd] / [B,S,KV,hd] -> (O in q.dtype, L fp32
    [B,S,KV,G])."""
    B, S, KV, G, hd = q.shape
    out, lse = flash_attention_kernel(
        to_bhsd(q.reshape(B, S, KV * G, hd)), to_bhsd(k), to_bhsd(v),
        causal=causal, window=window)
    out = from_bhsd(out, B).reshape(B, S, KV, G, hd)
    return out, lse.reshape(B, KV, G, S).permute(0, 3, 1, 2)


class FlashAttention(torch.autograd.Function):
    """(q [B,S,KV,G,hd], k/v [B,S,KV,hd], padded past their ``n`` real
    rows) -> O [B,S,KV,G,hd] in q.dtype.

    Forward: kernel K3 on the ``n`` real rows of CUDA tensors when
    ``use_kernel`` (O and L padded back with zeros), else ``_fwd``.
    Backward: ``_bwd`` from the saved (q, k, v, O, L); a padded query row
    gets no output gradient, so its L of 0 adds nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk, use_kernel, n):
        if use_kernel and q.is_cuda:
            out, L = _kernel_fwd(q[:, :n], k[:, :n], v[:, :n], causal,
                                 window)
            pad = q.shape[1] - n
            if pad:
                out = torch.nn.functional.pad(
                    out, (0, 0, 0, 0, 0, 0, 0, pad))
                L = torch.nn.functional.pad(L, (0, 0, 0, 0, 0, pad))
            o = out
        else:
            o, L = _fwd(q, k, v, causal, window, bq, bk, n)
            out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.cfg = (causal, window, bq, bk, n)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        dq, dk, dv = _bwd((q, k, v, o, L), do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_vjp(q, k, v, *, causal: bool = True, window: int = 0,
                        q_block: int = 512, kv_block: int = 1024,
                        use_kernel: bool = False):
    """Drop-in for attention_core on self-attention (contiguous positions).

    q: [B,S,H,hd]; k,v: [B,S,KV,hd] -> [B,S,H,hd].  Pads S to tile size.
    ``use_kernel`` runs the forward through kernel K3 on CUDA tensors.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    bq = min(q_block, S)
    bk = min(kv_block, S)
    S_p = -(-S // max(bq, bk)) * max(bq, bk)
    if S_p % bq:
        S_p = -(-S_p // bq) * bq
    pad = S_p - S
    q5 = q.reshape(B, S, KV, G, hd)
    if pad:
        q5 = torch.nn.functional.pad(q5, (0, 0, 0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    out = FlashAttention.apply(q5, k, v, causal, window, bq, bk, use_kernel,
                               S)
    return out[:, :S].reshape(B, S, H, hd)
