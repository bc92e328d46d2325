"""Physical KV-page layouts — the runtime seam behind paged serving.

A ``KVLayout`` describes the physical page format of a family's decode
cache: which decode-state ``leaves`` the pool tiles into pages, the ring
``window`` (0 = contiguous) and the storage ``kv_dtype``.  ``layout_for``
is the single capability authority: the registry asks it whether a family
pages, and the engine and pool take the returned layout as an argument.

The port ships the contiguous per-head ``kv`` layout and MLA's latent
``ckv`` / ``krope`` layout, in the family's compute dtype.  The ring-
wrapped ``window`` layout (ROADMAP queue 1 item 6) and int8 pages (item
8) raise naming their item.

Import discipline: this module depends only on the standard library — it
sits below both ``repro_torch.models.registry`` and
``repro_torch.serving.paged``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

#: storage dtypes a layout's data leaves may use ("fp32" = native compute
#: dtype).  ``ServeConfig.kv_dtype`` validates against this.
KV_DTYPES = ("fp32", "int8")

#: suffix of the per-row scale leaf a quantized layout carries
SCALE_SUFFIX = "_scale"

RING_TODO = ("ring-wrapped window pages are not ported yet — ROADMAP queue "
             "1 item 6 (sliding-window geometry)")
INT8_TODO = ("int8 KV pages are not ported yet — ROADMAP queue 1 item 8 "
             "(int8 KV pages)")


def check_kv_dtype_layout(kv_dtype: str, layout: Optional["KVLayout"]) -> None:
    """Quantized KV needs a per-head paged layout (the JAX package's rule);
    int8 storage itself is not ported yet.

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
    if layout.name == "latent":
        raise ValueError(
            f"kv_dtype={kv_dtype!r} cannot quantize MLA latent pages "
            f"(attn_kind='mla'): the latent rank is a contracted dim, so "
            "per-page scales would reassociate the absorbed sums — use "
            "kv_dtype='fp32' with attn_kind='mla'")
    raise ValueError(INT8_TODO)


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
    name: str                    # "kv" | "latent"
    leaves: Tuple[str, ...]      # decode-state leaves the pool pages
    window: int = 0              # > 0: ring-wrapped window pages
    kv_dtype: str = "fp32"       # "fp32" (native compute dtype)

    def __post_init__(self):
        if self.window:
            raise NotImplementedError(RING_TODO)
        if self.kv_dtype != "fp32":
            raise NotImplementedError(INT8_TODO)

    # -- geometry ----------------------------------------------------------

    @property
    def ring(self) -> bool:
        return self.window > 0

    @property
    def data_leaves(self) -> Tuple[str, ...]:
        return tuple(n for n in self.leaves if not n.endswith(SCALE_SUFFIX))

    def check_page_size(self, page_size: int) -> None:
        check_window_page_size(page_size, self.window)

    def max_page_size(self) -> int:
        """Largest power-of-two page the layout allows (unbounded for
        contiguous layouts — callers min() it against their own caps)."""
        return self.window & -self.window if self.window else 1 << 62

    def table_width(self, pages_per_slot: int, page_size: int) -> int:
        """Page-table columns per slot: the full logical block count."""
        return pages_per_slot

    def cell(self, block: int, width: int) -> int:
        """Table column holding logical block ``block``."""
        return block

    def live_tokens(self, seq_len: int) -> int:
        """Tokens of K/V a slot holds at sequence length ``seq_len``."""
        return seq_len

    def max_chunk_tokens(self, padded_len: int) -> int:
        """Largest prefill chunk the layout absorbs in one write-then-attend
        step (contiguous pages: unbounded up to the slot capacity)."""
        return padded_len

    def max_decode_span(self, n_steps: int) -> int:
        """Longest decode span one multi-step dispatch may write."""
        return n_steps

    def needed_start(self, cached_tokens: int, page_size: int) -> int:
        """First prompt block a new admission must still be able to read
        (contiguous layouts need every block)."""
        return 0

    def describe(self) -> dict:
        """Flat JSON-friendly identity for trace metadata."""
        return {"layout": self.name, "leaves": list(self.leaves),
                "window": self.window, "ring": self.ring,
                "kv_dtype": self.kv_dtype}


#: the contiguous per-head layout of full attention and MLA's contiguous
#: latent layout
KV_FULL = KVLayout("kv", ("k", "v"))
KV_LATENT = KVLayout("latent", ("ckv", "krope"))


def layout_for(cfg, kv_dtype: str = "fp32") -> Optional[KVLayout]:
    """The capability authority: which page layout (if any) serves this
    model config's decode cache.  None for families with nothing to page
    (attn_kind "none"); the unported geometry raises naming its ROADMAP
    item.  ``kv_dtype="int8"`` raises: rejected for MLA with the JAX
    package's error naming both knobs, not ported for per-head pages."""
    kind = getattr(cfg, "attn_kind", "none")
    if kind == "full":
        base = KV_FULL
    elif kind == "mla":
        base = KV_LATENT
    elif kind in ("swa", "local") and getattr(cfg, "window", 0) > 0:
        raise NotImplementedError(RING_TODO)
    else:
        return None
    if kv_dtype != "fp32":
        check_kv_dtype_layout(kv_dtype, base)
    return base
