"""The work a cell's tokens need, counted from shapes and tokens alone
(the same whatever implements it), and the per-layer readings built on it.

Attention kernels (per layer, per launch):

* paged decode over per-head pages (K1): a decode step's slots read the
  keys and values of their contexts once; where slots share a prefix
  (the same tokens at the same positions) those keys are counted once.
  Bytes = distinct positions x KV heads x head_dim x 2 (k, v) x 2 B, plus
  each query and output row; FLOPs = 4 x heads x head_dim x keys a token.
* paged decode over latent pages (K6): distinct positions x (R + rope) x
  2 B, plus q_lat, q_rope and the latent output; FLOPs = 2 x heads x keys
  x (R + rope) for the scores and 2 x heads x keys x R for the output.
* chunked prefill over per-head pages (K2): a chunk of c queries at start
  s reads s + c keys; FLOPs = 4 x heads x head_dim x (c s + c (c + 1) / 2).

Model FLOPs (``step_mfu``): 2 x the active parameters outside the input
table and the head for every computed token (prompt tokens not served
from the prefix cache, and decode tokens), the head (2 D V) once for every
token that needs logits (a request's first token and each decode token),
and attention by context as above (MLA at its expanded width: q.k over
nope + rope, p.v over v_head_dim).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from bench.core.peaks import HBM_BW, PEAK_FLOPS_BF16

BYTES = 2                  # bf16 pages, queries and outputs


def dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the counts need, from a configuration file."""
    d = {"D": cfg["hidden_size"], "L": cfg["num_hidden_layers"],
         "H": cfg["num_attention_heads"], "V": cfg["vocab_size"]}
    if "kv_lora_rank" in cfg:
        d.update(mla=True, R=cfg["kv_lora_rank"],
                 rp=cfg["qk_rope_head_dim"], nope=cfg["qk_nope_head_dim"],
                 dv=cfg["v_head_dim"], E=cfg["n_routed_experts"],
                 K=cfg["num_experts_per_tok"],
                 f=cfg["moe_intermediate_size"],
                 fs=cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
    else:
        d.update(mla=False, KV=cfg["num_key_value_heads"],
                 hd=cfg.get("head_dim") or d["D"] // d["H"],
                 F=cfg["intermediate_size"])
    return d


def body_params(d: Dict) -> int:
    """Active parameters a token runs through, outside the input table
    and the head (norms and biases left out: no products)."""
    D, H = d["D"], d["H"]
    if d["mla"]:
        attn = (D * (d["R"] + d["rp"]) + d["R"] * H * (d["nope"] + d["dv"])
                + H * d["dv"] * D + D * H * (d["nope"] + d["rp"]))
        ff = D * d["E"] + 3 * D * d["f"] * d["K"] + 3 * D * d["fs"]
    else:
        attn = 2 * D * H * d["hd"] + 2 * D * d["KV"] * d["hd"]
        ff = 3 * D * d["F"]
    return d["L"] * (attn + ff)


def attn_model_flops(d: Dict, pairs: float) -> float:
    """Attention FLOPs of ``pairs`` (query, key) pairs over all layers."""
    if d["mla"]:
        per = 2 * d["H"] * (d["nope"] + d["rp"] + d["dv"])
    else:
        per = 4 * d["H"] * d["hd"]
    return d["L"] * per * pairs


def distinct_positions(seqs: Sequence[np.ndarray]) -> int:
    """Positions the sequences hold once a shared prefix counts once: the
    size of their prefix trie (sorted, less each neighbour's common
    prefix)."""
    # fixed-width bytes sort as the tokens do (under one order of tokens),
    # which is all the trie size needs
    order = sorted(range(len(seqs)), key=lambda i: seqs[i].tobytes())
    total = sum(len(s) for s in seqs)
    for a, b in zip(order, order[1:]):
        x, y = seqs[a], seqs[b]
        m = min(len(x), len(y))
        diff = np.flatnonzero(x[:m] != y[:m])
        total -= int(diff[0]) if len(diff) else m
    return total


def decode_groups(slice_tokens) -> List[List[Tuple[np.ndarray, int]]]:
    """Decode tokens computed in one decode step, grouped: per engine step
    (one retire), a request's k-th decode token of that step belongs to
    decode step k.  Each entry is (the keys' token content, keys)."""
    groups = []
    for toks in slice_tokens:
        per_step: Dict[int, list] = {}
        seen: Dict[int, int] = {}
        for req, j in toks:
            if j == 0:
                continue                     # a prefill's first token
            k = seen.get(id(req), 0)
            seen[id(req)] = k + 1
            keys = len(req.prompt) + j
            content = np.concatenate([req.prompt, np.asarray(
                req.tokens[:j], dtype=np.int64)])[:keys]
            per_step.setdefault(k, []).append((content, keys))
        groups.extend(per_step[k] for k in sorted(per_step))
    return groups


def decode_kernel_time(d: Dict, groups, latent: bool) -> float:
    """Least seconds the paged decode kernel (K1, or K6 on latent pages)
    needs for ``groups``: each launch (one a layer and decode step) bound
    by the larger of its FLOPs and its bytes."""
    t = 0.0
    for g in groups:
        keys = sum(k for _, k in g)
        pos = distinct_positions([c for c, _ in g])
        n = len(g)
        if latent:
            w = d["R"] + d["rp"]
            byt = pos * w * BYTES + n * d["H"] * (w + d["R"]) * BYTES
            fl = 2 * d["H"] * keys * (w + d["R"])
        else:
            byt = pos * d["KV"] * d["hd"] * 2 * BYTES + \
                n * d["H"] * d["hd"] * 2 * BYTES
            fl = 4 * d["H"] * d["hd"] * keys
        t += d["L"] * max(fl / PEAK_FLOPS_BF16, byt / HBM_BW)
    return t


def prefill_kernel_time(d: Dict, chunks: Iterable[Tuple[int, int]]) -> float:
    """Least seconds chunked prefill over per-head pages (K2) needs for
    ``chunks`` of (start, n_valid)."""
    t = 0.0
    for s, c in chunks:
        byt = (s + c) * d["KV"] * d["hd"] * 2 * BYTES + \
            c * d["H"] * d["hd"] * 2 * BYTES
        fl = 4 * d["H"] * d["hd"] * (c * s + c * (c + 1) / 2)
        t += d["L"] * max(fl / PEAK_FLOPS_BF16, byt / HBM_BW)
    return t


def model_flops(d: Dict, chunks, groups, first_tokens: int) -> float:
    """Model FLOPs of the prefill chunks, the decode tokens and the heads
    of the first tokens (see the module docstring)."""
    body = 2 * body_params(d)
    head = 2 * d["D"] * d["V"]
    fl = 0.0
    for s, c in chunks:
        fl += body * c + attn_model_flops(d, c * s + c * (c + 1) / 2)
    for g in groups:
        for _, keys in g:
            fl += body + head + attn_model_flops(d, keys)
    return fl + head * first_tokens


def roofline_share(t_min: float, t_dev: float) -> Optional[float]:
    """Percent of the roofline a kernel reached; None where there is no
    work or no device time to read."""
    if t_min <= 0 or t_dev <= 0:
        return None
    return 100.0 * t_min / t_dev


def step_mfu(ctx) -> Optional[float]:
    """The whole step's share of the card's bf16 peak over the profiled
    slice: model FLOPs of the chunks and tokens the slice computed over
    (slice seconds x 989 TFLOP/s)."""
    if ctx.red is None or ctx.wall <= 0:
        return None
    fl = model_flops(ctx.dims, ctx.chunks, ctx.groups, ctx.first_tokens)
    return 100.0 * fl / (ctx.wall * PEAK_FLOPS_BF16) if fl > 0 else None


def launches_per_token(ctx) -> Optional[float]:
    """Host calls that put work on the card (kernel and graph launches)
    in the profiled slice, over the output tokens it computed."""
    if ctx.red is None:
        return None
    toks = sum(len(g) for g in ctx.groups) + ctx.first_tokens
    return ctx.red["launches"] / toks if toks else None
