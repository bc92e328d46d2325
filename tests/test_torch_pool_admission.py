"""The paged pool's one-shot admission (``can_admit``, ``alloc_for_insert``,
``insert_state``, ``insert``), ported from ``tests/test_serving.py``'s
paged-pool tests and ``tests/test_kv_layouts.py``'s ring rejection, and
held to the JAX pool on the same weights: the same pages allocated in the
same order, and page contents within 1e-5 (fp32 smoke prefill: the two
packages' K/V projections sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import registry as jax_registry
from repro.serving.paged import PagedKVCachePool as JaxPool
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import registry
from repro_torch.serving.layouts import SCALE_SUFFIX, layout_for
from repro_torch.serving.paged import PagedKVCachePool

ARCH = "qwen2.5-14b"


@pytest.fixture(scope="module")
def dense_setup():
    jcfg = jax_config(ARCH, smoke=True)
    jb = jax_registry.build(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True)
    bundle = registry.build(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams))
    return cfg, bundle, params, jb, jparams


def _pool(bundle, *args, **kw):
    return PagedKVCachePool(*args, lambda: bundle.init_decode_state(1, args[1]),
                            **kw)


def _prefill(bundle, params, plen, cache_len):
    toks = torch.arange(1, plen + 1, dtype=torch.int32)[None]
    with torch.no_grad():
        return bundle.serve_prefill_fn(params, toks, cache_len=cache_len)[1]


def test_paged_pool_allocator_properties(dense_setup):
    """Pages freed == pages allocated, no page aliasing across slots, the
    trash page is never handed out, and pages grow lazily with ``pos``."""
    cfg, bundle, params, _, _ = dense_setup
    pool = _pool(bundle, 3, 8, 32)
    assert pool.padded_len == 32 and pool.num_pages == 3 * 4 + 1

    def admit(rid, plen):
        return pool.insert(rid, _prefill(bundle, params, plen,
                                         pool.padded_len), n_tokens=plen)

    s0 = admit(0, 5)                        # 1 page
    s1 = admit(1, 17)                       # 3 pages
    assert len(pool.held[s0]) == 1 and len(pool.held[s1]) == 3
    assert 0 not in pool.held[s0] + pool.held[s1]          # trash reserved
    assert not set(pool.held[s0]) & set(pool.held[s1])     # no aliasing
    assert pool.kv_bytes_held() == 4 * pool.page_bytes
    assert pool.kv_bytes_held() < pool.kv_bytes_slotted()
    # lazy growth: slot 0 needs a second page only once pos crosses 8
    for expect_pages in (1, 1, 1, 2):
        assert pool.ensure_decode_capacity() == []
        assert len(pool.held[s0]) == expect_pages
        pool.advance()
    assert int(pool.pos[s0]) == 9
    assert pool.pages_allocated == 1 + 3 + 1
    # eviction returns every page and zeroes the host view
    pool.evict(s0)
    pool.evict(s1)
    assert pool.pages_held == 0
    assert pool.pages_freed == pool.pages_allocated == 5
    assert (pool.tables == 0).all() and (pool.pos == 0).all()
    assert pool.free_slots == 3


def test_paged_pool_exhaustion_reports_starved(dense_setup):
    cfg, bundle, params, _, _ = dense_setup
    # 3 usable pages (+ trash) for two slots of up to 2 pages each
    pool = _pool(bundle, 2, 8, 16, num_pages=4)
    st = _prefill(bundle, params, 8, pool.padded_len)
    assert pool.insert(0, st, n_tokens=8) is not None   # 1 page each
    assert pool.insert(1, st, n_tokens=8) is not None
    assert pool.can_admit(8) is False       # 1 page left, no slot anyway
    assert pool.alloc_for_insert(2, 8) is None
    # both slots sit on a page boundary (pos == 8): each wants a 2nd page,
    # but only one page remains — slot 1 starves
    starved = pool.ensure_decode_capacity()
    assert starved == [1] and len(pool.held[0]) == 2
    pool.evict(0)                           # freeing one unblocks the other
    assert pool.ensure_decode_capacity() == []


def test_insert_pages_equal_the_jax_pool(dense_setup):
    """The same admissions on the JAX pool and the port's: the same pages
    in the same tables, and their K/V within 1e-5."""
    cfg, bundle, params, jb, jparams = dense_setup
    jpool = JaxPool(3, 8, 32, lambda: jb.init_decode_state(1, 8))
    pool = _pool(bundle, 3, 8, 32)
    prefill = jax.jit(jb.serve_prefill_fn, static_argnames=("cache_len",))
    for rid, plen in enumerate((5, 17, 9)):
        toks = jnp.asarray(np.arange(1, plen + 1, dtype=np.int32)[None])
        _, jst = prefill(jparams, toks, cache_len=jpool.padded_len)
        js = jpool.insert(rid, jst, n_tokens=plen)
        ps = pool.insert(rid, _prefill(bundle, params, plen,
                                       pool.padded_len), n_tokens=plen)
        assert ps == js
    np.testing.assert_array_equal(pool.tables, jpool.tables)
    np.testing.assert_array_equal(pool.pos, jpool.pos)
    held = sorted(p for s in pool.held.values() for p in s)
    for n in ("k", "v"):
        got = pool.pages[n][:, held].numpy()
        want = np.asarray(jpool.pages[n])[:, held]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_int8_insert_quantizes_per_row(dense_setup):
    """An int8 pool stores what ``quantize_kv`` makes of the prefill's rows:
    every inserted row dequantizes to within half a step of its value."""
    cfg, bundle, params, _, _ = dense_setup
    layout = layout_for(cfg, kv_dtype="int8")
    pool = _pool(bundle, 2, 8, 16, layout=layout)
    st = _prefill(bundle, params, 11, pool.padded_len)
    slot = pool.insert(0, st, n_tokens=11)
    ids = torch.as_tensor(pool.tables[slot], dtype=torch.long)
    for n in ("k", "v"):
        q = pool.pages[n][:, ids].float()
        sc = pool.pages[n + SCALE_SUFFIX][:, ids].float()
        x = st[n][:, 0].reshape(q.shape)
        err = (q * sc[..., None] - x).abs()
        assert (err <= sc[..., None] / 2 + 1e-7).all()
        assert pool.pages[n].dtype == torch.int8


def test_window_ring_insert_rejected():
    """The contiguous insert path cannot represent a ring cache — the
    prefix path (alloc_prefix + paged prefill) is the only admission."""
    cfg = get_config("mixtral-8x22b", smoke=True)
    bundle = registry.build(cfg)
    assert bundle.kv_layout.ring
    pool = PagedKVCachePool(1, 4, 16, lambda: bundle.init_decode_state(1, 4),
                            layout=bundle.kv_layout)
    with pytest.raises(ValueError, match="ring"):
        pool.insert(0, {"k": None, "v": None}, n_tokens=8)
    with pytest.raises(ValueError, match="ring"):
        pool.alloc_for_insert(0, 8)
