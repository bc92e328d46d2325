"""Per-request sampling: params, packing, and the batched device sampler.

``SamplingParams`` travels with a request from ``engine.submit()`` /
``Session.generate`` down into the engine's decode loop.  The sampler is
**counter-based**: the token at absolute sequence index ``i`` (0-based over
prompt + generated) is drawn with ``fold_in(PRNGKey(seed), i)`` and
``categorical`` — the JAX package's draw, bit for bit: threefry2x32 as
jax 0.9.0 computes it (``jax_threefry_partitionable``, its default),
Gumbel noise in fp32 added to the fp32 filtered logits, argmax.  A
request's tokens are therefore a pure function of (prompt, params) —
independent of batch composition, slot assignment, warm vs cold caches and
pipeline depth — the same on the CPU and the GPU (the threefry rounds are
written in int64 tensor arithmetic with no overflow and no host sync), and
the same as the JAX package's for the same logits.  No RNG state is
carried between steps.

The noise can differ from ``jax.random.gumbel``'s by an ulp (the two
libraries' fp32 ``log``), and the top-p cumulative sum may round in
another order; either matters only where two perturbed logits tie within
that rounding.  Greedy rows (temperature 0) are argmax with the first
index on ties in both packages.

This module is import-light (numpy/torch only) so ``scheduler.Request``
can carry a ``SamplingParams`` without layering cycles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SamplingParams", "GREEDY", "pack_params", "sample_tokens",
           "threefry2x32", "fold_in", "random_bits", "gumbel",
           "PACKED_WIDTH"]

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
# threefry2x32 (20 rounds) in int64 tensor arithmetic, as jax 0.9.0 draws
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                        # Threefish key-schedule parity
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32 finfo.tiny: the low end of the uniform the Gumbel noise takes
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key, count):
    """Threefry-2x32 (Random123's 20 rounds, as ``jax._src.prng``'s
    unrolled lowering).  key: 2 int64 tensors, count: 2 int64 tensors
    (broadcastable; values in [0, 2**32)).  Returns the 2 output words as
    int64 tensors in [0, 2**32); no intermediate leaves int64."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (count[0] + ks[0]) & _MASK32
    x1 = (count[1] + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def fold_in(seed, idx):
    """``jax.random.fold_in(PRNGKey(seed), idx)`` per row: PRNGKey(seed) is
    the key (0, seed) for a 32-bit seed, and fold_in hashes the counter
    pair (0, idx) under it.  seed, idx: int tensors of one shape; returns
    the new key's 2 words."""
    zero = torch.zeros_like(seed, dtype=torch.int64)
    return threefry2x32((zero, seed.long() & _MASK32),
                        (zero, idx.long() & _MASK32))


def random_bits(key, V: int):
    """``jax.random.bits(key, (V,), uint32)`` per row under
    ``jax_threefry_partitionable`` (jax 0.9.0's default): the counters are
    the (hi, lo) halves of ``arange(V)`` as a uint64 — hi 0 — and the bits
    are the XOR of the two output words.  key: 2 int64 tensors [S];
    returns [S, V] int64 in [0, 2**32)."""
    k0, k1 = key
    j = torch.arange(V, dtype=torch.int64, device=k0.device)[None, :]
    b0, b1 = threefry2x32((k0[:, None], k1[:, None]), (torch.zeros_like(j), j))
    return b0 ^ b1


def gumbel(key, V: int):
    """[S, V] fp32 Gumbel noise, ``jax.random.gumbel(key, (V,))`` per row
    (mode "low"): the top 23 bits make a float in [1, 2), minus 1, scaled
    onto [tiny, 1) and clipped at tiny, then ``-log(-log(u))`` — all in
    fp32 as jax computes it (torch's and XLA's ``log`` may differ by an
    ulp)."""
    bits = random_bits(key, V)
    one = (bits >> 9) | 0x3F800000          # < 2**31: fits an int32
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.full((), _TINY, dtype=torch.float32, device=bits.device)
    u = torch.maximum(tiny, floats * (1.0 - tiny) + tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, packed, idx, *, sampled: bool = True):
    """Sample one token per row.  Pure function of (logits, packed, idx).

    logits [S, V] — next-token logits per row.
    packed [S, PACKED_WIDTH] int32 — per-row packed SamplingParams.
    idx    [S] int — absolute sequence index of the token being drawn
        (folded into the row's seed).
    sampled — the caller's host-side knowledge that some row has
        temperature > 0; False returns the argmax directly (all-greedy
        calls pay for the argmax only, with no device-to-host check).

    Returns [S] int32 tokens.  Rows with temperature == 0 take the argmax
    path (first index on ties); the filters follow the usual order:
    temperature scale -> top-k -> top-p -> categorical (Gumbel-max).
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
    g = gumbel(fold_in(seed, idx.to(logits.device)), V)
    drawn = torch.argmax(g + scaled, dim=-1).to(torch.int32)
    return torch.where(temp > 0.0, drawn, greedy)
