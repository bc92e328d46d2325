"""The port's ring-window page geometry against the JAX package, on the CPU.

Sliding-window families (mixtral: ``attn_kind="swa"``) page their K/V on a
ring of ``window // page_size`` cells per slot.  Held against the JAX
package on the same numpy inputs or the same weights
(``from_jax_params``):

  * the ``KVLayout`` geometry (table width, cells, live tokens, chunk and
    decode-span caps, ``needed_start``) on a grid of (window, page size,
    lengths), and ``ring_positions`` (floor modulo);
  * the plain versions of K4 (ring decode) and K5 (ring chunked prefill,
    snapshot-before-write) against the JAX oracles and the Pallas kernels
    in interpret mode, over ``tests/test_paged_attention.py``'s
    ``PAGED_CASES`` and ``RING_PREFILL_CASES`` (including S > window), the
    straddling page of a slot shorter than the window, and the snapshot
    case;
  * the ring writes of the paged model entry points (page contents and
    logits of a prefill that wraps the ring, then decode steps);
  * the ring pool's rotation invariants, step for step against
    ``repro.serving.PagedKVCachePool``;
  * mixtral-smoke engine streams on ring pages against the JAX engine's
    slotted ring decode: cold, warm, chunked, kernels off and on,
    speculation on (one draft on a ring), under preemption; and the
    port's paged streams against its own slotted ones.

Tolerances: fp32 atol 1e-5 (same math, another order of sums), bf16 1e-2
(one bf16 ulp); logits 1e-4 (fp32 smoke model, two layers); pages and
token streams exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JaxServeConfig
from repro.configs import get_config
from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention import ref as jax_ref
from repro.models import registry as jax_registry
from repro.models import transformer as jax_tf
from repro.serving import PagedKVCachePool as JaxPool
from repro.serving import ServingEngine as JaxEngine
from repro.serving.layouts import KVLayout as JaxLayout
from repro_torch.configs import ServeConfig
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.paged_attention import ops as port_ops
from repro_torch.kernels.paged_attention import ref as port_ref
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.layouts import KVLayout
from repro_torch.serving.paged import PagedKVCachePool

ARCH = "mixtral-8x22b"
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x)).to(TORCH[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(x).astype(JNP[dtype])


# ---------------------------------------------------------------------------
# Layout geometry and ring positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,ps", [(8, 4), (24, 8), (4096, 16), (12, 4),
                                       (16, 16)])
def test_ring_layout_geometry_matches_jax(window, ps):
    port = KVLayout("window", ("k", "v"), window=window)
    ref = JaxLayout("window", ("k", "v"), window=window)
    assert port.ring and ref.ring
    assert port.max_page_size() == ref.max_page_size()
    for pages_per_slot in (1, 3, window // ps, window // ps + 5):
        w = port.table_width(pages_per_slot, ps)
        assert w == ref.table_width(pages_per_slot, ps)
        for block in range(3 * max(w, 1)):
            assert port.cell(block, w) == ref.cell(block, w)
    for n in (0, 1, ps - 1, ps, window - 1, window, window + 1, 3 * window):
        assert port.live_tokens(n) == ref.live_tokens(n)
        assert port.max_chunk_tokens(n) == ref.max_chunk_tokens(n)
        assert port.max_decode_span(n) == ref.max_decode_span(n)
        assert port.needed_start(n, ps) == ref.needed_start(n, ps)
    assert port.describe() == ref.describe()


def test_layout_for_windowed_families_matches_jax():
    from repro.serving import layout_for as jax_layout_for
    from repro_torch.serving.layouts import layout_for
    for overrides in ({}, {"attn_kind": "local"}):
        cfg = get_config(ARCH, smoke=True).replace(**overrides)
        pcfg = port_get_config(ARCH, smoke=True).replace(**overrides)
        for dtype in ("fp32", "int8"):
            a, b = layout_for(pcfg, dtype), jax_layout_for(cfg, dtype)
            assert (a.name, a.leaves, a.window, a.kv_dtype) == \
                (b.name, b.leaves, b.window, b.kv_dtype)


@pytest.mark.parametrize("window", [8, 24])
def test_ring_positions_match_jax(window):
    """Pre-wrap (never-written cells negative), exact fill and wrapped
    rings, with the floor modulo."""
    lengths = np.asarray([0, 1, 5, window - 1, window, window + 3,
                          3 * window + 5], np.int32)
    p, ok = port_ref.ring_positions(torch.from_numpy(lengths), window,
                                    window)
    jp, jok = jax_ref.ring_positions(jnp.asarray(lengths), window, window)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert not ok[2, 5:].any() and ok[2, :5].all()


# ---------------------------------------------------------------------------
# K4: ring decode, plain version
# ---------------------------------------------------------------------------

def _decode_case(seed, slots, H, KV, hd, ps, n, dtype, window):
    """The JAX test's pool (random lengths) with the window's edge cases
    first: 1, a page, a page + 1 (straddling), the window, past the
    window."""
    rng = np.random.default_rng(seed)
    P = slots * n + 1
    q = rng.normal(size=(slots, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    edge = [1, ps + 1, window, window + ps + 3, ps]
    lengths = np.asarray([edge[s] if s < len(edge)
                          else rng.integers(1, 3 * window)
                          for s in range(slots)], np.int32)
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s in range(slots):
        for i in range(min(n, -(-int(lengths[s]) // ps))):
            table[s, i] = pid
            pid += 1
    k[0], v[0] = 1e4, -1e4                 # trash page: must never be read
    return q, k, v, table, lengths


#: tests/test_paged_attention.py PAGED_CASES as (slots, H, KV, hd, ps, n,
#: dtype), each run on a ring of window = n * ps, and one with a window
#: wider than the table (a max_seq_len below the window)
RING_DECODE_CASES = [
    (3, 4, 2, 32, 8, 4, "float32", 0),
    (2, 8, 8, 16, 4, 3, "float32", 0),
    (1, 2, 1, 64, 16, 2, "float32", 0),
    (4, 4, 2, 32, 8, 1, "float32", 0),
    (2, 4, 2, 32, 8, 3, "bfloat16", 0),
    (5, 6, 2, 64, 8, 4, "bfloat16", 0),
    (3, 4, 2, 32, 8, 2, "float32", 64),
]


@pytest.mark.parametrize("case", RING_DECODE_CASES)
def test_ring_decode_plain_matches_jax_ref_and_pallas(case):
    slots, H, KV, hd, ps, n, dtype, window = case
    window = window or n * ps
    q, k, v, table, lengths = _decode_case(1, slots, H, KV, hd, ps, n,
                                           dtype, window)
    if window > n * ps:                    # table narrower than the window
        lengths = np.minimum(lengths, n * ps)
    got = port_ops.paged_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), torch.from_numpy(table),
        torch.from_numpy(lengths), window=window, use_kernel=True)
    args = (_j(q, dtype), _j(k, dtype), _j(v, dtype), table, lengths)
    want = jax_ref.paged_attention_ref(*args, window=window)
    pallas = jax_ops.paged_attention(*args, window=window, use_kernel=True,
                                     interpret=True)
    for w in (want, pallas):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=TOL[dtype])


def test_ring_decode_straddling_page_masks_unwritten_cells():
    """A slot shorter than the window: the cells past its length on its
    last (straddling) page were never written; with a truncating modulo
    their positions would come out >= 0.  Poisoning them must change
    nothing, and the ring then equals the contiguous layout."""
    H, KV, hd, ps, n = 4, 2, 32, 8, 4
    window = n * ps
    q, k, v, table, _ = _decode_case(2, 2, H, KV, hd, ps, n, "float32",
                                     window)
    lengths = np.asarray([ps + 3, 2 * ps + 1], np.int32)
    table[:] = [[1, 2, 3, 0], [4, 5, 6, 0]]
    out = port_ref.paged_attention_ref(
        _t(q), _t(k), _t(v), torch.from_numpy(table),
        torch.from_numpy(lengths), window=window)
    k2, v2 = k.copy(), v.copy()
    k2[2, 3:], v2[2, 3:] = 1e4, -1e4       # slot 0: cells ps+3..2ps-1
    k2[6, 1:], v2[6, 1:] = 1e4, -1e4       # slot 1: cells 2ps+1..3ps-1
    poisoned = port_ref.paged_attention_ref(
        _t(q), _t(k2), _t(v2), torch.from_numpy(table),
        torch.from_numpy(lengths), window=window)
    contiguous = port_ref.paged_attention_ref(
        _t(q), _t(k), _t(v), torch.from_numpy(table),
        torch.from_numpy(lengths))
    torch.testing.assert_close(poisoned, out, rtol=0, atol=0)
    torch.testing.assert_close(contiguous, out, rtol=0, atol=1e-6)
    want = jax_ref.paged_attention_ref(_j(q), _j(k2), _j(v2), table,
                                       lengths, window=window)
    np.testing.assert_allclose(poisoned.numpy(), np.asarray(want),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# K5: ring chunked prefill, plain version
# ---------------------------------------------------------------------------

def _prefill_case(seed, H, KV, hd, ps, n, S):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, H, hd)).astype(np.float32)
    k = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    ck = rng.normal(size=(S, KV, hd)).astype(np.float32)
    cv = rng.normal(size=(S, KV, hd)).astype(np.float32)
    table = np.arange(1, n + 1, dtype=np.int32)
    return q, k, v, ck, cv, table


#: tests/test_paged_attention.py RING_PREFILL_CASES (window = n * ps), plus
#: a verify row on a wrapped ring and a ragged chunk on a half-filled one
RING_PREFILL_CASES = [
    (4, 2, 32, 8, 3, 16, 0, 16),      # cold start (ring empty)
    (4, 2, 32, 8, 3, 16, 30, 13),     # ring fully wrapped before the chunk
    (8, 8, 16, 4, 4, 8, 10, 5),       # MHA, partially filled ring
    (2, 1, 64, 8, 2, 32, 70, 27),     # chunk wider than the window (S > w)
    (6, 2, 64, 16, 4, 5, 77, 2),      # verify row, wrapped ring
    (4, 2, 32, 8, 4, 16, 13, 9),      # ragged chunk, straddling snapshot
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RING_PREFILL_CASES)
def test_ring_prefill_plain_matches_jax_ref_and_pallas(case, dtype):
    H, KV, hd, ps, n, S, start, n_valid = case
    window = n * ps
    q, k, v, ck, cv, table = _prefill_case(3, H, KV, hd, ps, n, S)
    got = port_ops.paged_ring_prefill(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), _t(ck, dtype),
        _t(cv, dtype), torch.from_numpy(table), start, n_valid,
        window=window, use_kernel=True)
    args = (_j(q, dtype), _j(k, dtype), _j(v, dtype), _j(ck, dtype),
            _j(cv, dtype), table, start, n_valid)
    want = jax_ref.paged_ring_prefill_ref(*args, window=window)
    pallas = jax_ops.paged_ring_prefill(*args, window=window,
                                        use_kernel=True, interpret=True)
    for w in (want, pallas):
        np.testing.assert_allclose(got.float().numpy()[:n_valid],
                                   np.asarray(w, np.float32)[:n_valid],
                                   atol=TOL[dtype])


def test_ring_prefill_reads_the_snapshot_not_the_written_ring():
    """Snapshot-before-write: the ring operand is the pool before the
    chunk's writes.  Writing the chunk into its cells first (what a
    write-then-attend would read) changes the result; the plain version on
    the snapshot equals the JAX kernel's."""
    H, KV, hd, ps, n = 4, 2, 32, 8, 3
    window, S, start, n_valid = 24, 16, 30, 13
    q, k, v, ck, cv, table = _prefill_case(4, H, KV, hd, ps, n, S)
    base = port_ref.paged_ring_prefill_ref(
        _t(q), _t(k), _t(v), _t(ck), _t(cv), torch.from_numpy(table), start,
        n_valid, window=window)
    kw, vw = k.copy(), v.copy()
    for i in range(n_valid):                  # the chunk's own writes
        pos = start + i
        page = table[(pos % window) // ps]
        kw[page, pos % ps], vw[page, pos % ps] = ck[i], cv[i]
    written = port_ref.paged_ring_prefill_ref(
        _t(q), _t(kw), _t(vw), _t(ck), _t(cv), torch.from_numpy(table),
        start, n_valid, window=window)
    assert (written[:n_valid] - base[:n_valid]).abs().max() > 1e-3
    pallas = jax_ops.paged_ring_prefill(
        _j(q), _j(k), _j(v), _j(ck), _j(cv), table, start, n_valid,
        window=window, use_kernel=True, interpret=True)
    np.testing.assert_allclose(base.numpy()[:n_valid],
                               np.asarray(pallas)[:n_valid], atol=1e-5)


# ---------------------------------------------------------------------------
# The paged model entry points on ring pages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weights(arch=ARCH):
    cfg = get_config(arch, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(5))
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_ring_paged_prefill_and_decode_match_jax(kernels):
    """Two chunks (the second wraps the window-8 ring) then decode steps
    on a ring of 2 cells: logits within 1e-4 and identical pages after
    every call, with the plain gather path (kernels off) or K5 / K4's
    plain versions (kernels on; JAX Pallas in interpret mode)."""
    cfg, params, np_params = _weights()
    pcfg = port_get_config(ARCH, smoke=True)
    pparams = from_jax_params(np_params)
    ps, width = 4, cfg.window // 4
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    jpages = {n: jnp.zeros((L, 2 * width + 1, ps, KV, hd))
              for n in ("k", "v")}
    ppages = {n: torch.zeros((L, 2 * width + 1, ps, KV, hd))
              for n in ("k", "v")}
    table = np.asarray([1, 2], np.int32)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, 13)
    for start, chunk in ((0, 8), (8, 5)):
        bucket = 8
        t = np.zeros((1, bucket), np.int32)
        t[0, :chunk] = toks[start:start + chunk]
        state = dict(page_table=jnp.asarray(table), start=start,
                     n_valid=chunk)
        jl, jpages = jax_tf.lm_paged_prefill(
            cfg, params, jnp.asarray(t), dict(state, pages=jpages),
            use_pallas=kernels)
        pl, ppages = port_tf.lm_paged_prefill(
            pcfg, pparams, torch.from_numpy(t),
            dict(state, page_table=torch.from_numpy(table), pages=ppages),
            use_kernels=kernels)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
        for n in ("k", "v"):
            np.testing.assert_allclose(ppages[n].numpy(),
                                       np.asarray(jpages[n]), atol=1e-5)
    tok = np.asarray([[int(np.argmax(np.asarray(jl)[0]))]], np.int32)
    for pos in range(13, 17):
        jstate = dict(pages=jpages, page_table=jnp.asarray(table[None]),
                      pos=jnp.asarray([pos], jnp.int32))
        jl, jpages = jax_tf.lm_paged_decode(cfg, params, jnp.asarray(tok),
                                            jstate, use_pallas=kernels)
        pstate = dict(pages=ppages, page_table=torch.from_numpy(table[None]),
                      pos=torch.tensor([pos], dtype=torch.int32))
        pl, ppages = port_tf.lm_paged_decode(pcfg, pparams,
                                             torch.from_numpy(tok), pstate,
                                             use_kernels=kernels)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
        tok = np.asarray([[int(np.argmax(np.asarray(jl)[0]))]], np.int32)
    for n in ("k", "v"):
        np.testing.assert_allclose(ppages[n].numpy(), np.asarray(jpages[n]),
                                   atol=1e-5)


def test_windowed_prefill_cache_len_is_the_window():
    """The slotted decode state of a windowed family holds ``window``
    positions (``decode_cache_len``), as the JAX package's does."""
    cfg, _, _ = _weights()
    pcfg = port_get_config(ARCH, smoke=True)
    for seq in (4, cfg.window, 40):
        assert port_tf.decode_cache_len(pcfg, seq) == \
            jax_tf.decode_cache_len(cfg, seq)
        state = port_registry.build(pcfg).init_decode_state(1, seq)
        assert state["k"].shape[2] == min(seq, cfg.window)


# ---------------------------------------------------------------------------
# The ring pool, step for step against the JAX pool
# ---------------------------------------------------------------------------

def _pool_view(pool):
    return (pool.tables.tolist(), {s: list(h) for s, h in pool.held.items()},
            pool.refcount.tolist(), sorted(pool._cached_lru),
            pool.pos.tolist(), pool.cow_copies, pool.pages_allocated,
            pool.pages_freed)


def test_ring_pool_rotation_invariants_match_jax():
    """``tests/test_kv_layouts.py``'s ring invariants, with every step's
    tables, held pages, refcounts and parked pages equal to the JAX
    pool's: a windowed slot holds at most ``window // ps`` pages, rotation
    parks indexed pages (refcount 0) in the LRU and reuses private pages
    in place, a second admission matches the live tail, and no private
    page sits in two tables."""
    cfg = get_config(ARCH, smoke=True)                   # window = 8
    pcfg = port_get_config(ARCH, smoke=True)
    ps = 4
    jb, pb = jax_registry.build(cfg), port_registry.build(pcfg)
    jp = JaxPool(2, ps, 32, lambda: jb.init_decode_state(1, ps),
                 layout=jb.kv_layout, enable_prefix_cache=True)
    pp = PagedKVCachePool(2, ps, 32,
                          lambda: pb.init_decode_state(1, ps, device="meta"),
                          layout=pb.kv_layout, enable_prefix_cache=True)
    assert pp.table_width == jp.table_width == cfg.window // ps == 2
    prompt = list(range(100, 120))                       # 20 tokens
    for pool in (jp, pp):
        s0, cached = pool.alloc_prefix(0, prompt)
        assert cached == 0 and len(pool.held[s0]) == 2
    assert _pool_view(pp) == _pool_view(jp)
    for lo, hi in ((0, 7), (8, 15), (16, 19)):           # window-capped
        for pool in (jp, pp):
            assert pool.prepare_chunk(0, lo, hi)
            pool.commit_prefix(0, prompt[:hi + 1])
            assert len(pool.held[0]) <= pool.table_width
        assert _pool_view(pp) == _pool_view(jp)
    assert pp.cached_pages >= 2
    assert all(pp.refcount[p] == 0 for p in pp._cached_lru)
    assert pp.ring_rotations > 0
    for pool in (jp, pp):
        pool.pos[0] = 20
        assert pool.ensure_decode_capacity() == []
        assert pool.safe_decode_span(0, 4) == 4
    assert _pool_view(pp) == _pool_view(jp)
    outs = [pool.alloc_prefix(1, prompt) for pool in (jp, pp)]
    assert outs[1] == outs[0] and outs[1][1] >= 12
    assert _pool_view(pp) == _pool_view(jp)
    shared = set(pp.held[0]) & set(pp.held[1])
    assert all(pp.refcount[p] >= 2 for p in shared)
    assert all(pp.refcount[p] == 1 for p in set(pp.held[1]) - shared)
    # a rotation-free span stops at the first cell another block holds
    pp.pos[1] = 20
    jp.pos[1] = 20
    assert pp.safe_decode_span(1, 8) == jp.safe_decode_span(1, 8)
    for pool in (jp, pp):
        pool.rewind(1, 18)                   # ring rewind keeps the cells
    assert _pool_view(pp) == _pool_view(jp)
    for pool in (jp, pp):
        pool.evict(0)
        pool.evict(1)
    assert _pool_view(pp) == _pool_view(jp)
    assert pp.pages_held == 0 and pp.pages_allocated == pp.pages_freed


# ---------------------------------------------------------------------------
# The engine: mixtral-smoke streams against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _engines(kernels=False, **kw):
    """The JAX slotted engine (the reference streams) and a port engine on
    the same weights and knobs (``kernels``: the JAX ``use_pallas`` and
    the port's ``use_kernels``).

    The reference is the JAX *slotted* ring decode, whose streams the JAX
    paged ring engine equals (``tests/test_kv_layouts.py``): the JAX paged
    ring engine returns another stream now and then on the CPU backend
    (a reference-side flake, see ROADMAP), its slotted engine never did in
    repeated runs."""
    cfg, params, np_params = _weights()
    base = dict(max_batch=2, max_seq_len=40, max_new_tokens=6,
                decode_steps=2, page_size=4)
    base.update(kw)
    ref = {k: v for k, v in base.items()
           if k not in ("page_size", "num_pages", "prefill_chunk_tokens",
                        "spec_tokens", "enable_spec")}
    je = JaxEngine(cfg, JaxServeConfig(**ref, kv_layout="slotted",
                                       use_pallas=kernels), params=params)
    pe = ServingEngine(port_get_config(ARCH, smoke=True),
                       ServeConfig(**base, use_kernels=kernels),
                       params=from_jax_params(np_params), device="cpu")
    return je, pe


#: cold prompts that wrap the window-8 ring, their warm repeat (full and
#: partial prefix hits), chunked prefill, and speculation on repetitive
#: prompts (one draft a verify on a ring)
ENGINE_CASES = {
    "cold_then_warm": dict(
        batches=[_prompts(1, [7, 12, 5, 17]),
                 _prompts(1, [7, 12, 5, 17]) + [_prompts(1, [12])[0][:8]
                                                 + [3, 4, 5]]],
        kw=dict(enable_spec=False)),
    "chunked": dict(batches=[_prompts(2, [21, 9, 14])],
                    kw=dict(prefill_chunk_tokens=4, enable_spec=False)),
    "spec": dict(batches=[[[7, 3] * 8, _prompts(3, [9])[0], [1] * 13]],
                 kw=dict(spec_tokens=4, max_new_tokens=12)),
}


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_mixtral_engine_streams_match_jax(case, kernels):
    """Greedy streams on ring pages equal the JAX engine's; the warm batch
    hits the prefix cache, the spec case verifies drafts (one a verify on
    a ring), every case rotates ring cells and returns every page."""
    c = ENGINE_CASES[case]
    je, pe = _engines(kernels, **c["kw"])
    assert pe.paged and pe.layout.ring
    new = c["kw"].get("max_new_tokens", 6)
    for prompts in c["batches"]:
        want = je.generate(prompts, new)
        assert pe.generate(prompts, new) == want
    pm = pe.metrics
    if case == "cold_then_warm":
        assert pm.prefix_hit_tokens > 0
    if case == "spec":
        assert pm.drafted_tokens > 0
    assert pe.pool.ring_rotations > 0
    assert pe.pool.pages_held == 0
    assert pe.pool.pages_allocated == pe.pool.pages_freed


def test_mixtral_preemption_resumes_to_the_jax_tokens():
    """Short prompts admit on part of their rings; growing them into full
    rings of 4 cells (page 2, window 8) oversubscribes the pool's 12
    pages, which forces preemption; the resumed requests re-prefill and
    emit the JAX engine's tokens; every page returns."""
    prompts = _prompts(7, [3, 4, 3, 5])
    kw = dict(max_batch=4, max_seq_len=24, max_new_tokens=10, num_pages=13,
              page_size=2, decode_steps=2)
    je, pe = _engines(True, **kw)
    want = je.generate(prompts, 10)
    assert pe.generate(prompts, 10) == want
    assert pe.metrics.preemptions >= 1
    assert int((pe.pool.refcount > 0).sum()) == 0
    assert pe.pool.pages_allocated == pe.pool.pages_freed


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_mixtral_paged_equals_slotted(kernels):
    """The port's ring pages emit its own slotted ring cache's tokens,
    cold and warm; the ring's peak bytes stay at or under the slotted
    window-sized pool's."""
    prompts = _prompts(11, [7, 12, 5, 9, 20])
    prompts.append(list(prompts[0]))
    _, pp = _engines(kernels, enable_spec=False)
    ps = ServingEngine(port_get_config(ARCH, smoke=True),
                       ServeConfig(max_batch=2, max_seq_len=40,
                                   max_new_tokens=6, decode_steps=2,
                                   kv_layout="slotted", use_kernels=kernels),
                       params=pp.params, device="cpu")
    assert not ps.paged
    want = ps.generate(prompts, 6)
    assert pp.generate(prompts, 6) == want
    pp.metrics.reset()
    pp.results.clear()
    assert pp.generate(prompts, 6) == want
    assert pp.metrics.prefix_hit_tokens > 0
    sp = pp.metrics.summary()
    assert 0 < sp["kv_bytes_peak"] <= sp["kv_bytes_slotted"]


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-lite-16b"])
def test_moe_slotted_batch_routes_each_slot_alone(arch):
    """The slotted pool decodes its slots as one batch; MoE must route
    each slot's token alone, as the JAX engine's per-slot decode does (a
    capacity group over the batch let slots displace each other's
    experts).  Streams of four concurrent requests equal the JAX slotted
    engine's."""
    cfg, params, np_params = _weights(arch)
    knobs = dict(max_batch=4, max_seq_len=40, max_new_tokens=8,
                 decode_steps=2, kv_layout="slotted")
    prompts = _prompts(13, [7, 12, 5, 9])
    want = JaxEngine(cfg, JaxServeConfig(**knobs),
                     params=params).generate(prompts, 8)
    pe = ServingEngine(port_get_config(arch, smoke=True),
                       ServeConfig(**knobs),
                       params=from_jax_params(np_params), device="cpu")
    assert not pe.paged and pe.generate(prompts, 8) == want
