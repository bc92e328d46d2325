"""The work of a model whose windowed and global layers alternate, and
whose MoE layers this card holds only some experts of (K-EXAONE's share),
counted from the configuration and the slice's tokens alone.

Layers (from ``layer_types`` / ``mlp_layer_types``): ``Lg`` global layers
attend every key, ``Lw`` windowed ones at most ``window`` keys a query;
``n_dense`` leading dense layers, then MoE layers routing top-``K`` of
``E`` experts, of which this card holds ``held``.

* Model FLOPs (``step_mfu``): 2 x the parameters a token runs through —
  attention (q, k, v, o) in every layer, the dense layers' SwiGLU, the
  shared experts and the router in every MoE layer, and K x held / E of
  the routed experts' 3 D f (the expected picks that land here) — for
  every computed token; the head (2 D V) for every token that needs
  logits; attention 4 H hd a (query, key) pair, over every earlier key in
  a global layer and the latest ``window`` in a windowed one.
* Paged decode (K1 on the global layers, K4 on the windowed ones; one
  symbol, ``paged_decode_kernel``): a launch per layer and decode step;
  bytes = positions read x KV x hd x 2 (k, v) x 2 B — a global layer reads
  the keys' distinct positions, a windowed one each slot's last
  min(keys, window) — plus each query and output row; FLOPs = 4 H hd x
  keys read.
* Chunked prefill of a chunk of c queries at start s: on the global
  layers (K2) s + c keys' bytes and 4 H hd (c s + c (c + 1) / 2) FLOPs; on
  the windowed layers (K5) the ring snapshot's min(s, window) positions
  and the chunk's own c keys, and 4 H hd x sum over the chunk's queries of
  min(position + 1, window) FLOPs; plus the queries and outputs.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

from bench.core.peaks import HBM_BW, PEAK_FLOPS_BF16
from bench.core.work import distinct_positions

BYTES = 2                  # bf16 pages, queries and outputs

#: the K2 / K5 tensor-core body's symbol and its RING template argument
_WGMMA = re.compile(r"paged_prefill_wgmma_kernel\W*(true|false)")


def dims(cfg: Dict) -> Dict:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    kinds = cfg["layer_types"]
    return {"D": D, "H": H, "KV": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or D // H,
            "F": cfg["intermediate_size"], "f": cfg["moe_intermediate_size"],
            "fs": cfg["moe_intermediate_size"] * cfg["num_shared_experts"],
            "E": cfg["router_experts"], "held": cfg["num_experts"],
            "K": cfg["num_experts_per_tok"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"],
            "n_dense": sum(k == "dense" for k in cfg["mlp_layer_types"]),
            "Lg": sum(k == "full_attention" for k in kinds),
            "Lw": sum(k == "sliding_attention" for k in kinds),
            "W": cfg["sliding_window"]}


def body_flops(d: Dict) -> float:
    """2 x the parameters a computed token runs through, outside the
    input table and the head."""
    D, H, hd, KV = d["D"], d["H"], d["hd"], d["KV"]
    attn = 2 * D * H * hd + 2 * D * KV * hd
    n_moe = d["L"] - d["n_dense"]
    moe = (D * d["E"] + 3 * D * d["fs"]
           + d["K"] * d["held"] / d["E"] * 3 * D * d["f"])
    return 2.0 * (d["L"] * attn + d["n_dense"] * 3 * D * d["F"]
                  + n_moe * moe)


def window_pairs(s: int, c: int, w: int) -> int:
    """(query, key) pairs of c queries at positions s .. s + c - 1, each
    attending its latest min(position + 1, w) keys."""
    full = max(0, min(s + c, w) - s)        # queries still inside the ramp
    ramp = full * s + full * (full + 1) // 2
    return ramp + (c - full) * w


def attn_flops(d: Dict, global_pairs: float, window_pairs_: float) -> float:
    return 4.0 * d["H"] * d["hd"] * (d["Lg"] * global_pairs
                                     + d["Lw"] * window_pairs_)


def model_flops(d: Dict, chunks, groups, first_tokens: int) -> float:
    head = 2.0 * d["D"] * d["V"]
    fl = 0.0
    for s, c in chunks:
        fl += body_flops(d) * c + attn_flops(
            d, c * s + c * (c + 1) / 2, window_pairs(s, c, d["W"]))
    for g in groups:
        for _, keys in g:
            fl += body_flops(d) + head + attn_flops(d, keys,
                                                    min(keys, d["W"]))
    return fl + head * first_tokens


def step_mfu(ctx) -> Optional[float]:
    """The slice's model FLOPs over (slice seconds x 989 TFLOP/s), %."""
    if ctx.red is None or ctx.wall <= 0:
        return None
    fl = model_flops(dims(ctx.config), ctx.chunks, ctx.groups,
                     ctx.first_tokens)
    return 100.0 * fl / (ctx.wall * PEAK_FLOPS_BF16) if fl > 0 else None


def _bound(fl: float, byt: float) -> float:
    return max(fl / PEAK_FLOPS_BF16, byt / HBM_BW)


def decode_time(d: Dict, groups) -> float:
    """Least seconds of the decode steps' K1 (global) and K4 (windowed)
    launches."""
    row = d["KV"] * d["hd"] * 2 * BYTES
    t = 0.0
    for g in groups:
        n = len(g)
        keys = sum(k for _, k in g)
        recent = sum(min(k, d["W"]) for _, k in g)
        qo = n * d["H"] * d["hd"] * 2 * BYTES
        per = 4 * d["H"] * d["hd"]
        t += d["Lg"] * _bound(per * keys, distinct_positions(
            [c for c, _ in g]) * row + qo)
        t += d["Lw"] * _bound(per * recent, recent * row + qo)
    return t


def global_prefill_time(d: Dict, chunks: Iterable[Tuple[int, int]]) -> float:
    """Least seconds of the chunks' K2 launches on the global layers."""
    row = d["KV"] * d["hd"] * 2 * BYTES
    t = 0.0
    for s, c in chunks:
        byt = (s + c) * row + c * d["H"] * d["hd"] * 2 * BYTES
        fl = 4 * d["H"] * d["hd"] * (c * s + c * (c + 1) / 2)
        t += d["Lg"] * _bound(fl, byt)
    return t


def ring_prefill_time(d: Dict, chunks: Iterable[Tuple[int, int]]) -> float:
    """Least seconds of the chunks' K5 launches on the windowed layers."""
    row = d["KV"] * d["hd"] * 2 * BYTES
    t = 0.0
    for s, c in chunks:
        byt = (min(s, d["W"]) + c) * row + c * d["H"] * d["hd"] * 2 * BYTES
        fl = 4 * d["H"] * d["hd"] * window_pairs(s, c, d["W"])
        t += d["Lw"] * _bound(fl, byt)
    return t


def prefill_seconds(red: Dict) -> Tuple[float, float]:
    """Device seconds of chunked prefill on (global, windowed) layers: the
    bf16 body by its RING argument, K5's fp32 kernel, and each split
    merge (one symbol for both) counted with the body launch before it."""
    glob = ring = 0.0
    last = None
    for name, s, e in sorted(red["kernels"], key=lambda k: k[1]):
        m = _WGMMA.search(name)
        if m:
            last = m.group(1) == "true"
        elif "paged_ring_prefill_kernel" in name:
            last = True
        elif "prefill_merge_kernel" not in name or last is None:
            continue
        if last:
            ring += e - s
        else:
            glob += e - s
    return glob / 1e6, ring / 1e6
