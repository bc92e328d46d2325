"""Per-request sampling: params, packing, and the batched device sampler.

``SamplingParams`` travels with a request from ``engine.submit()`` /
``Session.generate`` down into the engine's decode loop.  The sampler is
**counter-based**: the token at absolute sequence index ``i`` (0-based over
prompt + generated) is drawn from Philox4x32-10 keyed by ``(seed, i)``
with the vocabulary index as the counter, turned into Gumbel noise for a
Gumbel-max draw.  A request's tokens are therefore a pure function of
(prompt, params) — independent of batch composition, slot assignment,
warm vs cold caches and pipeline depth — and the same on the CPU and the
GPU (the Philox rounds are written in int64 tensor arithmetic with no
overflow).  No RNG state is carried between steps.

The draws differ from the JAX package's threefry bits (``fold_in(
PRNGKey(seed), i)`` + ``categorical``); bit-identical sampling across the
two packages is a ROADMAP item.  Greedy rows (temperature 0) are argmax
with the first index on ties in both packages, so greedy output matches.

This module is import-light (numpy/torch only) so ``scheduler.Request``
can carry a ``SamplingParams`` without layering cycles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SamplingParams", "GREEDY", "pack_params", "sample_tokens",
           "philox4x32", "PACKED_WIDTH"]

# Packed layout, one int32 row per slot:
#   [bitcast(f32 temperature), bitcast(f32 top_p), top_k, seed]
PACKED_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters, validated at construction.

    temperature: 0 disables sampling (greedy argmax); > 0 scales logits.
    top_k: keep the k highest logits (0 disables the filter).
    top_p: nucleus filter — keep the smallest prob mass >= top_p
        (1.0 disables the filter).
    seed: per-request PRNG seed; the only source of randomness.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        t = self.temperature
        if not isinstance(t, (int, float)) or isinstance(t, bool) or t < 0:
            raise ValueError(
                f"temperature={t!r} must be a float >= 0")
        k = self.top_k
        if not isinstance(k, (int, np.integer)) or isinstance(k, bool) or k < 0:
            raise ValueError(f"top_k={k!r} must be an int >= 0")
        p = self.top_p
        if not isinstance(p, (int, float)) or isinstance(p, bool) \
                or not 0.0 < p <= 1.0:
            raise ValueError(f"top_p={p!r} must be a float in (0, 1]")
        s = self.seed
        if not isinstance(s, (int, np.integer)) or isinstance(s, bool) \
                or not 0 <= s < 2 ** 31:
            raise ValueError(f"seed={s!r} must be an int in [0, 2**31)")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def pack_params(p: SamplingParams) -> np.ndarray:
    """One [PACKED_WIDTH] int32 row; floats travel bit-exact via bitcast."""
    return np.array([
        np.float32(p.temperature).view(np.int32),
        np.float32(p.top_p).view(np.int32),
        np.int32(p.top_k),
        np.int32(p.seed),
    ], dtype=np.int32)


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 tensor arithmetic
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # key schedule (Weyl) constants


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product m * c (c < 2**32),
    from 16-bit partial products so nothing overflows int64."""
    mh, ml = m >> 16, m & 0xFFFF
    ch, cl = c >> 16, c & 0xFFFF
    mid = mh * cl + ml * ch                 # < 2**33
    low = ml * cl + ((mid & 0xFFFF) << 16)  # < 2**33
    hi = mh * ch + (mid >> 16) + (low >> 32)
    return hi & _MASK32, low & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10.  counter: 4 int64 tensors (broadcastable, values in
    [0, 2**32)); key: 2 int64 tensors.  Returns the 4 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _gumbel(seed, idx, V: int, device):
    """[S, V] Gumbel noise: Philox keyed (seed, idx) per row, counter =
    vocabulary index; the first output word becomes a uniform in (0, 1)."""
    j = torch.arange(V, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w, _, _, _ = philox4x32((j, zero, zero, zero),
                            (seed.long()[:, None] & _MASK32,
                             idx.long()[:, None] & _MASK32))
    u = (w.double() + 0.5) / 2.0 ** 32
    return -torch.log(-torch.log(u))


def sample_tokens(logits, packed, idx, *, sampled: bool = True):
    """Sample one token per row.  Pure function of (logits, packed, idx).

    logits [S, V] — next-token logits per row.
    packed [S, PACKED_WIDTH] int32 — per-row packed SamplingParams.
    idx    [S] int — absolute sequence index of the token being drawn
        (the Philox key's second word).
    sampled — the caller's host-side knowledge that some row has
        temperature > 0; False returns the argmax directly (all-greedy
        calls pay for the argmax only, with no device-to-host check).

    Returns [S] int32 tokens.  Rows with temperature == 0 take the argmax
    path (first index on ties); the filters follow the usual order:
    temperature scale -> top-k -> top-p -> Gumbel-max draw.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    packed = packed.to(logits.device)
    temp = packed[:, 0].contiguous().view(torch.float32)
    top_p = packed[:, 1].contiguous().view(torch.float32)
    top_k = packed[:, 2].long()
    seed = packed[:, 3]
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    # top-k: threshold at the k-th largest value (ties past k survive —
    # deterministic either way, which is all reproducibility needs)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(top_k, 0, V)
    kth = torch.gather(desc, 1, torch.clamp(k - 1, min=0)[:, None])
    neg = torch.full((), -float("inf"), device=logits.device)
    scaled = torch.where((scaled >= kth) | (k <= 0)[:, None], scaled, neg)
    # top-p over the post-k distribution: keep the smallest prefix of the
    # sorted probs whose mass reaches top_p (the first always stays)
    probs = torch.softmax(scaled, dim=-1)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(p_desc, dim=-1)
    kept = (cum - p_desc) < top_p[:, None]
    cutoff = torch.where(kept, p_desc,
                         torch.full((), float("inf"),
                                    device=logits.device)).amin(dim=-1)
    keep = (probs >= cutoff[:, None]) | (top_p >= 1.0)[:, None]
    scaled = torch.where(keep, scaled, neg)
    g = _gumbel(seed, idx.to(logits.device), V, logits.device)
    drawn = torch.argmax(scaled.double() + g, dim=-1).to(torch.int32)
    return torch.where(temp > 0.0, drawn, greedy)
