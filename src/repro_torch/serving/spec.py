"""Speculative decoding: n-gram drafting + deterministic-replay verify.

The engine speculates in three places that mirror its pipeline:

* **draft** (pure host, between plan and submit): an ``NGramDrafter``
  per request proposes up to ``spec_tokens`` continuation tokens by
  suffix-matching the request's own history (prompt + generated) —
  prompt-lookup decoding, no draft model, no device work.
* **verify** (submit): the drafts ride one paged-prefill-style forward
  (``paged_verify_fn``) that scatters their KV straight into the
  request's pages and returns logits at *every* drafted position.
* **accept** (retire): the longest draft prefix that matches what the
  engine itself would have emitted is kept; the slot's ``pos`` and
  page-table tail are rewound past the last accepted token
  (``PagedKVCachePool.rewind``), freeing pages the rejected suffix
  touched.

**Deterministic replay.**  Verification recomputes, at each drafted
position, exactly the token the non-speculative engine would emit
there — ``sample_tokens`` over the verify logits with the request's
own params and counter-based PRNG index (argmax when temperature is
0) — and accepts draft ``d_j`` iff it equals that token.  Because the
sampler is a pure function of (logits, params, position), spec-on is
**token-identical to spec-off for greedy and sampled requests alike**;
nothing distributional is traded away: for a deterministic
(point-mass) drafter like n-gram lookup, standard residual
accept-reject degenerates to exactly this rule.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

__all__ = ["NGramDrafter", "DrafterPool"]


class NGramDrafter:
    """Suffix-table drafter over one request's (prompt + generated) history.

    Indexes every ``ngram``-gram that has a known continuation, keyed to
    its most recent occurrence; ``propose`` looks up the current suffix
    and replays up to ``k`` tokens that followed it last time.  The
    index grows incrementally (history only ever extends — preemption
    resumes with prompt + generated, never a shorter sequence).
    """

    def __init__(self, ngram: int = 2):
        if ngram < 1:
            raise ValueError(f"ngram={ngram!r} must be an int >= 1")
        self.ngram = ngram
        self._index: Dict[Tuple[int, ...], int] = {}
        self._seen = 0              # gram end positions indexed so far

    def propose(self, history: Sequence[int], k: int) -> Tuple[int, ...]:
        """Up to ``k`` draft tokens continuing ``history`` (may be empty)."""
        n = self.ngram
        hist = list(history)
        # index grams ending at i (continuation = hist[i], so i < len)
        for i in range(max(self._seen, n), len(hist)):
            self._index[tuple(hist[i - n:i])] = i
        self._seen = max(self._seen, len(hist))
        if k <= 0 or len(hist) < n:
            return ()
        j = self._index.get(tuple(hist[-n:]))
        if j is None:
            return ()
        # Replay from the match, re-anchoring whenever the replay runs off
        # the end of recorded history: the most recent occurrence of a
        # periodic suffix sits close to the end, so a plain
        # ``hist[j:j + k]`` slice would return 1-2 tokens however large
        # ``k`` is.  The working copy extends with the drafted tokens so
        # the re-anchor suffix tracks the speculation; the *index* only
        # ever holds real history (a rejected draft poisons nothing).
        real = len(hist)
        work = hist                     # extended in place with drafts
        out = []
        while len(out) < k:
            tok = work[j]
            out.append(tok)
            work.append(tok)
            j += 1
            if j >= real:
                j = self._index.get(tuple(work[-n:]))
                if j is None:
                    break
        return tuple(out)


class DrafterPool:
    """Per-request drafters, keyed by rid; dropped when the request ends."""

    def __init__(self, ngram: int = 2):
        self.ngram = ngram
        self._by_rid: Dict[int, NGramDrafter] = {}

    def propose(self, rid: int, history: Sequence[int],
                k: int) -> Tuple[int, ...]:
        d = self._by_rid.get(rid)
        if d is None:
            d = self._by_rid[rid] = NGramDrafter(self.ngram)
        return d.propose(history, k)

    def drop(self, rid: int) -> None:
        self._by_rid.pop(rid, None)
