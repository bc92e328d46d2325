"""Physical KV-page layouts — the runtime seam behind paged serving.

A ``KVLayout`` describes the physical page format of a family's decode
cache: which decode-state ``leaves`` the pool tiles into pages, the ring
``window`` (0 = contiguous) and the storage ``kv_dtype``.  ``layout_for``
is the single capability authority: the registry asks it whether a family
pages, and the engine and pool take the returned layout as an argument.

Four geometries: the contiguous per-head ``kv`` layout (full
attention), MLA's latent ``ckv`` / ``krope`` layout, the ring-wrapped
``window`` layout of sliding-window attention — the table is a ring of
``window // page_size`` cells, token ``t`` lives at cell ``(t % window) //
page_size``, and a cell's page is reused in place as the sequence wraps —
and the two-kind ``hybrid`` layout of a model whose windowed and global
layers alternate (``ModelConfig.layer_pattern``): the global layers take
contiguous ``kv`` pages from the page budget, and each slot owns a fixed
ring of ``ring_window // page_size`` cells for every windowed layer.
Per-head layouts store their pages in the compute dtype or, with
``kv_dtype="int8"`` (``quantized_layout``), as int8 rows with one bf16
scale per (page, offset, kv-head) row in an extra ``*_scale`` leaf;
``quantize_kv`` is the single quantizer every write path calls.

Import discipline: this module depends only on torch — it sits below both
``repro_torch.models.registry`` and ``repro_torch.serving.paged``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

#: storage dtypes a layout's data leaves may use ("fp32" = native compute
#: dtype).  ``ServeConfig.kv_dtype`` validates against this.
KV_DTYPES = ("fp32", "int8")

#: suffix of the per-row scale leaf a quantized layout carries
SCALE_SUFFIX = "_scale"



def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of a K/V leaf: one bf16 scale
    per (..., head) row over the trailing head_dim.  Returns ``(q,
    scale)`` with ``q`` int8 in [-127, 127] and ``x ~ q * scale[...,
    None]``.

    The scale is rounded to bf16 *before* the row is divided by it, so
    dequant with the stored scale reconstructs exactly what was
    quantized; the clip guards the bf16 round-down that could push a
    ratio past 127.  The only quantizer: the decode append and the
    prefill scatter both call it, so a written token's page bytes are a
    pure function of its row (warm == cold, kernel on == off)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()[..., None]), -127, 127)
    return q.to(torch.int8), scale


def check_kv_dtype_layout(kv_dtype: str, layout: Optional["KVLayout"]) -> None:
    """Quantized KV needs a per-head paged layout (the JAX package's rule).

    MLA latent pages stay fp: the latent rank is a *contracted* dim of the
    absorbed-decode einsums, so per-page scales would reassociate those
    sums and break the latent == per-head equivalence."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r} not in {KV_DTYPES}")
    if kv_dtype == "fp32":
        return
    if layout is None:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} requires a paged KV layout, but this "
            "family serves slotted-only (no layout) — drop kv_dtype or "
            "pick a paged family")
    if layout.ring_window:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} has no int8 form of the two-kind "
            "(hybrid) layout: the windowed layers' ring cells keep no "
            "scale leaves — use kv_dtype='fp32' with a layer_pattern of "
            "windowed and global layers")
    if layout.name == "latent":
        raise ValueError(
            f"kv_dtype={kv_dtype!r} cannot quantize MLA latent pages "
            f"(attn_kind='mla'): the latent rank is a contracted dim, so "
            "per-page scales would reassociate the absorbed sums — use "
            "kv_dtype='fp32' with attn_kind='mla'")


def check_window_page_size(page_size: int, window: int) -> None:
    """Ring-wrapped window pages must tile the window (the JAX package's
    rule, kept for ``ServeConfig.check_window``)."""
    if window <= 0:
        return
    if page_size > window:
        raise ValueError(
            f"page_size={page_size} exceeds the attention window="
            f"{window}: a page that never fits the window can never be "
            "cached or freed correctly — shrink page_size or force "
            "kv_layout='slotted'")
    if window % page_size:
        raise ValueError(
            f"page_size={page_size} does not divide the attention "
            f"window={window}: ring-wrapped window pages must tile the "
            "window exactly")


@dataclass(frozen=True)
class KVLayout:
    """Physical page layout of one attention family's decode cache."""
    name: str                    # "kv" | "latent" | "window"
    leaves: Tuple[str, ...]      # decode-state leaves the pool pages
    window: int = 0              # > 0: ring-wrapped window pages
    kv_dtype: str = "fp32"       # "fp32" (native) | "int8" (+ scale leaves)
    # two-kind ("hybrid") layouts: the windowed layers' ring (positions),
    # and how many of the stacked layers are windowed; ``leaves`` are then
    # the global layers' contiguous pages
    ring_window: int = 0
    ring_layers: int = 0

    # -- geometry ----------------------------------------------------------

    @property
    def ring(self) -> bool:
        return self.window > 0

    @property
    def quantized(self) -> bool:
        return self.kv_dtype != "fp32"

    @property
    def data_leaves(self) -> Tuple[str, ...]:
        """The K/V leaves — ``leaves`` minus a quantized layout's scale
        leaves (which exist only in the page pool)."""
        return tuple(n for n in self.leaves if not n.endswith(SCALE_SUFFIX))

    def page_template(self, blank: dict) -> dict:
        """One-page pool template ``{leaf: [L, 1, ps, ...]}`` from the
        bundle's blank decode state: the data leaves as they are for fp
        layouts; int8 data leaves plus a bf16 scale leaf (head_dim dropped:
        one scale per (page, offset, kv-head)) for quantized ones."""
        if not self.quantized:
            return {k: blank[k] for k in self.leaves}
        one = {}
        for name in self.data_leaves:
            x = blank[name]
            one[name] = torch.zeros(x.shape, dtype=torch.int8,
                                    device=x.device)
            one[name + SCALE_SUFFIX] = torch.zeros(
                x.shape[:-1], dtype=torch.bfloat16, device=x.device)
        return one

    def check_page_size(self, page_size: int) -> None:
        check_window_page_size(page_size, self.window or self.ring_window)

    def max_page_size(self) -> int:
        """Largest power-of-two page the layout allows: the lowest set bit
        of the window or ring (unbounded for contiguous layouts — callers
        min() it against their own caps)."""
        w = self.window or self.ring_window
        return w & -w if w else 1 << 62

    def table_width(self, pages_per_slot: int, page_size: int) -> int:
        """Page-table columns per slot: the full logical block count for
        contiguous layouts, the ring size for windowed ones."""
        if not self.window:
            return pages_per_slot
        return min(pages_per_slot, self.window // page_size)

    def cell(self, block: int, width: int) -> int:
        """Table column holding logical block ``block``."""
        return block % width if self.ring else block

    def live_tokens(self, seq_len: int) -> int:
        """Tokens of K/V a slot holds at sequence length ``seq_len``."""
        return min(seq_len, self.window) if self.ring else seq_len

    def max_chunk_tokens(self, padded_len: int) -> int:
        """Largest prefill chunk the layout absorbs in one write-then-attend
        step: a ring chunk longer than the window would overwrite cells its
        own early queries still need."""
        return self.window if self.ring else padded_len

    def max_decode_span(self, n_steps: int) -> int:
        """Longest decode span one multi-step dispatch may write: a ring
        span longer than the window would wrap onto cells its own earlier
        steps still attend."""
        return min(n_steps, self.window) if self.ring else n_steps

    def needed_start(self, cached_tokens: int, page_size: int) -> int:
        """First prompt block a new admission must still be able to read
        when ``cached_tokens`` come from the prefix cache: suffix queries
        attend keys no older than ``cached_tokens - window + 1``
        (contiguous layouts need every block)."""
        if not self.window:
            return 0
        return max(0, cached_tokens - self.window + 1) // page_size

    def describe(self) -> dict:
        """Flat JSON-friendly identity for trace metadata."""
        out = {"layout": self.name, "leaves": list(self.leaves),
               "window": self.window, "ring": self.ring,
               "kv_dtype": self.kv_dtype}
        if self.ring_window:
            out.update(ring_window=self.ring_window,
                       ring_layers=self.ring_layers)
        return out

    # -- sharding ----------------------------------------------------------

    def page_pspec(self, name: str, leaf, model_size: int) -> tuple:
        """Placement of one page-pool leaf (whole-model shape).  Per-head
        pages ``[L,P,ps,KV,hd]`` shard their KV heads over "model" when
        the count divides it, else replicate (the port shards heads
        whole; the JAX layout shards ``head_dim`` then); int8 scales
        ``[L,P,ps,KV]`` shard exactly when their data leaf does.  Latent
        (ckv/krope) pages replicate: the rank is a contracted dim of every
        absorbed-MLA product.  Pages replicate over the data axes — any
        slot's pages live anywhere."""
        spec = [None] * leaf.ndim
        if model_size > 1 and leaf.shape[3 if leaf.ndim > 3 else -1] \
                % model_size == 0:
            if (name in ("k", "v") and leaf.ndim == 5) or \
                    (name in ("k" + SCALE_SUFFIX, "v" + SCALE_SUFFIX)
                     and leaf.ndim == 4):
                spec[3] = "model"
        return tuple(spec)


#: the contiguous per-head layout of full attention and MLA's contiguous
#: latent layout
KV_FULL = KVLayout("kv", ("k", "v"))
KV_LATENT = KVLayout("latent", ("ckv", "krope"))


def quantized_layout(base: Optional[KVLayout],
                     kv_dtype: str) -> Optional[KVLayout]:
    """The ``kv_dtype`` storage variant of a base layout: identity for
    "fp32"; "int8" appends one ``*_scale`` leaf per data leaf.  Raises
    ``check_kv_dtype_layout``'s error for layouts that cannot quantize
    (MLA latents, slotted-only families)."""
    if kv_dtype == "fp32":
        return base
    check_kv_dtype_layout(kv_dtype, base)
    leaves = base.leaves + tuple(n + SCALE_SUFFIX for n in base.leaves)
    return KVLayout(base.name, leaves, window=base.window, kv_dtype=kv_dtype)


def layout_for(cfg, kv_dtype: str = "fp32") -> Optional[KVLayout]:
    """The capability authority: which page layout (if any) serves this
    model config's decode cache — None for families with nothing to page
    (attn_kind "none").  ``kv_dtype`` selects the storage variant
    (``quantized_layout``)."""
    kind = getattr(cfg, "attn_kind", "none")
    pattern = getattr(cfg, "layer_pattern", "")
    if "G" in pattern and "L" in pattern:
        base = KVLayout("hybrid", ("k", "v"), ring_window=cfg.window,
                        ring_layers=sum(cfg.layer_kind(i) == "L"
                                        for i in range(cfg.num_layers)))
    elif kind == "full" or (pattern and "L" not in pattern):
        base = KV_FULL
    elif kind == "mla":
        base = KV_LATENT
    elif kind in ("swa", "local") and getattr(cfg, "window", 0) > 0:
        base = KVLayout("window", ("k", "v"), window=cfg.window)
    else:
        return None
    return quantized_layout(base, kv_dtype)
