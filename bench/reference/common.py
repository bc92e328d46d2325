"""Plain operations shared by the references: float32, TF32 off.

``precision="fp8"`` is the control: every product with a weight takes its
operands through float8 e4m3 (weights scaled per output column, activations
per row), the step below the bfloat16 that the configurations state.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0            # largest finite float8 e4m3 value


def no_tf32() -> None:
    """Products in full float32 on the card (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded through float8 e4m3, scaled along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [..., K] @ w [K, N] in float32; the control rounds both operands
    through fp8 first."""
    w = w.float()
    if precision == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, offset: torch.Tensor, eps: float):
    """RMS norm with the scale stored as an offset from one."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        (1.0 + offset.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, halves rotated: x [S, heads, d], pos [S]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, block: int = 512):
    """q [S, H, d], k [S, H, d], v [S, H, dv] (heads already matched)
    -> [S, H, dv]; causal softmax, query blocks so scores stay small."""
    S = q.shape[0]
    out = []
    kt = k.permute(1, 2, 0)                                  # [H, d, S]
    vh = v.permute(1, 0, 2)                                  # [H, S, dv]
    for q0 in range(0, S, block):
        qb = q[q0:q0 + block].permute(1, 0, 2)               # [H, n, d]
        n = qb.shape[1]
        s = torch.matmul(qb, kt[:, :, :q0 + n]) * scale      # [H, n, T]
        qi = torch.arange(q0, q0 + n, device=q.device)[:, None]
        ki = torch.arange(q0 + n, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
        out.append(torch.matmul(torch.softmax(s, dim=-1), vh[:, :q0 + n])
                   .permute(1, 0, 2))
    return torch.cat(out, dim=0)


def swiglu(x, w_gate, w_up, w_down, precision: str):
    return linear(torch.nn.functional.silu(linear(x, w_gate, precision))
                  * linear(x, w_up, precision), w_down, precision)


def matrix_std(shape) -> float:
    """Spread of a weight matrix: one over the root of its fan-in (the
    second-to-last axis), so activations keep unit size through depth."""
    return 1.0 / math.sqrt(shape[-2])


def layer(tree, i: int):
    """Layer ``i`` of a tree of stacked [L, ...] leaves, in float32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def head_logits(cfg, weights, x, eps_key: str, precision: str):
    """Final norm and the untied head: x [n, D] -> [n, V] float32."""
    h = rms_norm(x, weights["final_norm"]["scale"], cfg[eps_key])
    return linear(h, weights["lm_head"], precision)
