"""Prompt tokens the page pool served from its prefix cache over the
prompt tokens the window admitted (the engine's counters
``prefix_hit_tokens`` and ``prefill_tokens``, window start to end)."""


def read(ctx):
    hit = ctx.counters.get("prefix_hit_tokens", 0)
    total = hit + ctx.counters.get("prefill_tokens", 0)
    return 100.0 * hit / total if total else None
