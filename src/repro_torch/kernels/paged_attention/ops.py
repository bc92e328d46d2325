"""Public paged-attention entry points in the serving pool's layouts.

``use_kernel`` selects the hand-written CUDA kernel wrapper (which itself
takes the plain version for CPU tensors, see ``kernel.py``); False runs the
plain PyTorch version (``ref.py``) on any device — the engine's
``ServeConfig.use_kernels=False`` comparison arm.  Head conventions match
``repro_torch.models.attention`` (head h reads kv-head ``h // G``).
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention.kernel import (
    paged_attention_kernel, paged_mla_kernel, paged_mla_prefill_kernel,
    paged_prefill_kernel, paged_ring_prefill_kernel)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_mla_attention_ref, paged_mla_prefill_ref,
    paged_prefill_ref, paged_ring_prefill_ref)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    window: int = 0, k_scale=None, v_scale=None,
                    use_kernel: bool = False):
    """Decode.  q: [slots, H, hd]; k/v_pages: [P, ps, KV, hd]; page_table:
    [slots, n_table] int32 (0-padded = trash page); lengths: [slots] int32.
    ``window > 0`` selects the ring layout's position mapping (the
    sliding-window mask included); ``k_scale``/``v_scale`` [P, ps, KV]
    bf16 mark int8 pages.  Returns [slots, H, hd] in q.dtype."""
    if not use_kernel:
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   window=window, k_scale=k_scale,
                                   v_scale=v_scale)
    slots, H, hd = q.shape
    KV = k_pages.shape[2]
    out = paged_attention_kernel(q.reshape(slots, KV, H // KV, hd).contiguous(),
                                 k_pages, v_pages, page_table, lengths,
                                 window=window, k_scale=k_scale,
                                 v_scale=v_scale)
    return out.reshape(slots, H, hd)


def paged_prefill(q, k_pages, v_pages, page_table, start: int, n_valid: int,
                  *, k_scale=None, v_scale=None, use_kernel: bool = False):
    """Chunked prefill.  q: [S, H, hd] — one request's bucketed chunk
    (post-rope; query i at absolute position ``start + i``); k/v_pages: the
    pool AFTER the chunk's K/V were written; page_table: [n] int32 — the
    request's row; ``k_scale``/``v_scale`` mark int8 pages.  Rows past
    ``n_valid`` are padding and must not be read.  Returns [S, H, hd] in
    q.dtype."""
    if not use_kernel:
        return paged_prefill_ref(q, k_pages, v_pages, page_table, start,
                                 n_valid, k_scale=k_scale, v_scale=v_scale)
    S, H, hd = q.shape
    KV = k_pages.shape[2]
    out = paged_prefill_kernel(q.reshape(S, KV, H // KV, hd).contiguous(),
                               k_pages, v_pages, page_table, start, n_valid,
                               k_scale=k_scale, v_scale=v_scale)
    return out.reshape(S, H, hd)


def paged_ring_prefill(q, k_pages, v_pages, chunk_k, chunk_v, page_row,
                       start: int, n_valid: int, *, window: int,
                       k_scale=None, v_scale=None, use_kernel: bool = False):
    """Ring-layout chunked prefill, snapshot-before-write: k/v_pages are the
    pool BEFORE the chunk's writes and chunk_k/chunk_v [S, KV, hd] the
    chunk's own post-rope keys / values (its writes wrap onto cells its
    early queries still need, so they are not read back through the
    table).  ``k_scale``/``v_scale`` mark int8 *snapshot* pages; the chunk
    operands stay fp.  Rows past ``n_valid`` are padding and must not be
    read.  Returns [S, H, hd] in q.dtype."""
    if not use_kernel:
        return paged_ring_prefill_ref(q, k_pages, v_pages, chunk_k, chunk_v,
                                      page_row, start, n_valid,
                                      window=window, k_scale=k_scale,
                                      v_scale=v_scale)
    S, H, hd = q.shape
    KV = k_pages.shape[2]
    out = paged_ring_prefill_kernel(
        q.reshape(S, KV, H // KV, hd).contiguous(), k_pages, v_pages,
        chunk_k.contiguous(), chunk_v.contiguous(), page_row, start, n_valid,
        window=window, k_scale=k_scale, v_scale=v_scale)
    return out.reshape(S, H, hd)


def paged_mla_attention(q_lat, q_rope, ckv_pages, krope_pages, page_table,
                        lengths, *, scale: float, use_kernel: bool = False):
    """Absorbed-MLA decode over latent pages.  q_lat: [slots, H, R];
    q_rope: [slots, H, rp]; ckv_pages [P, ps, R]; krope_pages [P, ps, rp];
    ``scale`` the qk-dimension softmax scale.  Returns the latent output
    [slots, H, R] in q_lat.dtype (the caller up-projects through W_uv)."""
    fn = paged_mla_kernel if use_kernel else paged_mla_attention_ref
    return fn(q_lat, q_rope, ckv_pages, krope_pages, page_table, lengths,
              scale=scale)


def paged_mla_prefill(q_lat, q_rope, ckv_pages, krope_pages, page_table,
                      start: int, n_valid: int, *, scale: float,
                      use_kernel: bool = False):
    """Absorbed-MLA chunked prefill over latent pages (one request's
    bucketed chunk; the pages already hold its latents).  Rows past
    ``n_valid`` are padding and must not be read.  Returns [S, H, R] in
    q_lat.dtype."""
    fn = paged_mla_prefill_kernel if use_kernel else paged_mla_prefill_ref
    return fn(q_lat, q_rope, ckv_pages, krope_pages, page_table, start,
              n_valid, scale=scale)
