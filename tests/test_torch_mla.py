"""The port's absorbed-MLA paged attention (K6 decode, K7 chunked prefill)
against the JAX package.

The plain versions — ``repro_torch.kernels.paged_attention.ref``'s
``paged_mla_attention_ref`` / ``paged_mla_prefill_ref``, which the K6/K7
wrappers run for CPU tensors — are held against the JAX oracles and the
Pallas kernels in interpret mode on the same numpy inputs, with the trash
page 0 filled with values that would swamp any score that read it, and a
prefill bucket whose second Pallas query block is all padding.

Tolerances: fp32 atol 1e-5 (the same math, another summation order);
bf16 2**-6 (inputs round identically from fp32; both sides accumulate in
fp32 and round once, so outputs |x| < 4 may differ by one bf16 ulp).
Prefill rows past ``n_valid`` are padding and never compared.  The CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda_kernels.py``.

The engine on latent pages (deepseek-v2-lite smoke, JAX weights carried
across): preemption under page pressure resumes to the same tokens as the
JAX engine, a fully cached prompt re-admits without touching the shared
ckv / krope pages (both full-hit regimes, mirroring
``tests/test_kv_layouts.py``), and int8 pages raise the JAX package's
error.
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
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import ServeConfig
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.paged_attention import kernel as port_kernel
from repro_torch.kernels.paged_attention import ops as port_ops
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paged import block_hashes

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the smoke config's qk-dimension scale, (16 + 8) ** -0.5
SCALE = 24 ** -0.5


def _t(x, dtype):
    return torch.from_numpy(x).to(TORCH[dtype])


def _j(x, dtype):
    return jnp.asarray(x).astype(JNP[dtype])


def _pages(rng, P, ps, R, rp):
    ckv = rng.normal(size=(P, ps, R)).astype(np.float32)
    kr = rng.normal(size=(P, ps, rp)).astype(np.float32)
    ckv[0], kr[0] = 1e4, -1e4             # trash page: must never be read
    return ckv, kr


def _decode_case(seed, slots, H, R, rp, ps, n):
    """Disjoint per-slot tables padded with the trash page 0; lengths
    include 1, ps, ps + 1 and a full table."""
    rng = np.random.default_rng(seed)
    edge = [1, ps, ps + 1, n * ps]
    lengths = np.asarray([edge[s] if s < len(edge)
                          else rng.integers(1, n * ps + 1)
                          for s in range(slots)], np.int32)
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s in range(slots):
        for i in range(-(-int(lengths[s]) // ps)):
            table[s, i] = pid
            pid += 1
    ckv, kr = _pages(rng, slots * n + 1, ps, R, rp)
    q_lat = rng.normal(size=(slots, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(slots, H, rp)).astype(np.float32)
    return q_lat, q_rope, ckv, kr, table, lengths


DECODE_CASES = [
    # (slots, H, R, rp, ps, n)
    (5, 4, 32, 8, 8, 4),        # the smoke geometry
    (3, 2, 64, 16, 4, 3),
    (2, 16, 128, 64, 16, 2),    # full-width heads and rope dim
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_mla_decode_plain_matches_jax_ref_and_pallas(case, dtype):
    q_lat, q_rope, ckv, kr, table, lengths = _decode_case(1, *case)
    got = port_ops.paged_mla_attention(
        _t(q_lat, dtype), _t(q_rope, dtype), _t(ckv, dtype), _t(kr, dtype),
        torch.from_numpy(table), torch.from_numpy(lengths), scale=SCALE,
        use_kernel=True).float().numpy()
    jargs = (_j(q_lat, dtype), _j(q_rope, dtype), _j(ckv, dtype),
             _j(kr, dtype), table, lengths)
    want = jax_ref.paged_mla_attention_ref(*jargs, scale=SCALE)
    pallas = jax_ops.paged_mla_attention(*jargs, scale=SCALE,
                                         use_kernel=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=TOL[dtype])


PREFILL_CASES = [
    # (H, R, rp, ps, n, S, start, n_valid)
    (4, 32, 8, 8, 6, 5, 0, 5),       # verify rows, cold
    (4, 32, 8, 8, 6, 5, 21, 3),      # verify rows after a prefix, ragged
    (4, 32, 8, 8, 6, 16, 9, 13),     # bucket with a padded tail
    (2, 64, 16, 4, 10, 32, 3, 32),   # full bucket, deep start
    # 256-row bucket: Pallas tiles it in two 128-row query blocks, the
    # second all padding (skipped at grid level)
    (4, 32, 8, 16, 10, 256, 17, 100),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_mla_prefill_plain_matches_jax_ref_and_pallas(case, dtype):
    H, R, rp, ps, n, S, start, n_valid = case
    assert start + n_valid <= (n - 1) * ps     # the trash tail stays unread
    rng = np.random.default_rng(2)
    ckv, kr = _pages(rng, n + 2, ps, R, rp)
    table = np.arange(2, n + 2, dtype=np.int32)
    table[-1] = 0                              # trash-padded tail entry
    q_lat = rng.normal(size=(S, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(S, H, rp)).astype(np.float32)
    got = port_ops.paged_mla_prefill(
        _t(q_lat, dtype), _t(q_rope, dtype), _t(ckv, dtype), _t(kr, dtype),
        torch.from_numpy(table), start, n_valid, scale=SCALE,
        use_kernel=True).float().numpy()[:n_valid]
    jargs = (_j(q_lat, dtype), _j(q_rope, dtype), _j(ckv, dtype),
             _j(kr, dtype), table, start, n_valid)
    want = jax_ref.paged_mla_prefill_ref(*jargs, scale=SCALE)
    pallas = jax_ops.paged_mla_prefill(*jargs, scale=SCALE, use_kernel=True,
                                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32)[:n_valid],
                               atol=TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32)[:n_valid],
                               atol=TOL[dtype])


def test_mla_trash_page_never_read():
    """Rewriting the trash page and every page past a slot's length leaves
    the decode output unchanged."""
    q_lat, q_rope, ckv, kr, table, lengths = _decode_case(3, 4, 4, 32, 8, 8,
                                                          4)
    args = lambda c, k: (torch.from_numpy(q_lat), torch.from_numpy(q_rope),
                         torch.from_numpy(c), torch.from_numpy(k),
                         torch.from_numpy(table), torch.from_numpy(lengths))
    base = port_ops.paged_mla_attention(*args(ckv, kr), scale=SCALE)
    ckv2, kr2 = ckv.copy(), kr.copy()
    ckv2[0], kr2[0] = -3e3, 5e3
    for s in range(table.shape[0]):            # tail of each last page
        L = int(lengths[s])
        if L % 8:
            ckv2[table[s, L // 8], L % 8:] = 7e3
            kr2[table[s, L // 8], L % 8:] = -7e3
    out = port_ops.paged_mla_attention(*args(ckv2, kr2), scale=SCALE)
    torch.testing.assert_close(out, base, rtol=0, atol=0)


def test_mla_cpu_wrappers_take_plain_versions_without_counting():
    """On CPU tensors K6/K7's wrappers run the plain versions and launch
    nothing, so their counters stay put."""
    q_lat, q_rope, ckv, kr, table, lengths = _decode_case(4, 2, 4, 32, 8, 8,
                                                          2)
    t = [torch.from_numpy(a) for a in (q_lat, q_rope, ckv, kr, table,
                                       lengths)]
    before = (port_kernel.paged_mla_kernel.launches,
              port_kernel.paged_mla_prefill_kernel.launches)
    a = port_ops.paged_mla_attention(*t, scale=SCALE, use_kernel=True)
    b = port_ops.paged_mla_attention(*t, scale=SCALE, use_kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    port_ops.paged_mla_prefill(t[0][:1].repeat(3, 1, 1),
                               t[1][:1].repeat(3, 1, 1), t[2], t[3], t[4][0],
                               0, 3, scale=SCALE, use_kernel=True)
    assert (port_kernel.paged_mla_kernel.launches,
            port_kernel.paged_mla_prefill_kernel.launches) == before


# ---------------------------------------------------------------------------
# The engine on latent pages
# ---------------------------------------------------------------------------

ARCH = "deepseek-v2-lite-16b"


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = get_config(ARCH, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(11))
    return cfg, params, jax.tree.map(np.asarray, params)


def _engines(**kw):
    """A JAX and a port engine on the same weights and ServeConfig knobs."""
    cfg, params, np_params = _weights()
    base = dict(max_batch=2, max_seq_len=40, max_new_tokens=5,
                decode_steps=2, page_size=8)
    base.update(kw)
    je = JaxEngine(cfg, JaxServeConfig(**base), params=params)
    pe = ServingEngine(port_get_config(ARCH, smoke=True),
                       ServeConfig(**base),
                       params=from_jax_params(np_params), device="cpu")
    return je, pe


def test_mla_preemption_resumes_to_the_jax_tokens():
    """Oversubscribed latent pages force preemption; resumed requests re-
    prefill (from their own cached prefix) and emit the JAX engine's
    tokens, and every page is returned."""
    cfg = _weights()[0]
    prompts = [list(np.random.default_rng(7).integers(0, cfg.vocab_size, n))
               for n in (14, 15)]
    # one slot's worst case (+1), short of two slots' worst
    kw = dict(max_seq_len=32, max_new_tokens=12, num_pages=7,
              prefill_chunk_tokens=6)
    je, pe = _engines(**kw)
    want = je.generate(prompts, 12)
    got = pe.generate(prompts, 12)
    assert got == want
    assert pe.metrics.preemptions >= 1
    assert int((pe.pool.refcount > 0).sum()) == 0
    assert pe.pool.pages_allocated == pe.pool.pages_freed


def test_mla_cow_isolation_on_fully_cached_prompt():
    """A fully page-aligned cached prompt re-admits without touching the
    shared latent pages, through either full-hit regime: last-token replay
    + copy-on-write (the blocks are indexed by a longer prompt, so the
    exact prompt's next token is unknown), then the zero-dispatch fast path
    once its greedy next token is memoized."""
    cfg = _weights()[0]
    rng = np.random.default_rng(9)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 16)]
    _, ep = _engines(decode_steps=1, max_new_tokens=8)
    ep.submit(prompt + [int(t) for t in rng.integers(0, cfg.vocab_size, 3)],
              max_new_tokens=8)
    ep.run()
    shared = [ep.pool._index[h][0] for h in block_hashes(prompt, 8)]
    assert shared and all(p is not None for p in shared)
    snap = {pid: (ep.pool.pages["ckv"][:, pid].clone(),
                  ep.pool.pages["krope"][:, pid].clone()) for pid in shared}

    def intact():
        for pid, (c0, k0) in snap.items():
            assert torch.equal(ep.pool.pages["ckv"][:, pid], c0)
            assert torch.equal(ep.pool.pages["krope"][:, pid], k0)

    assert ep.pool.cached_next_token(prompt) is None
    rb = ep.submit(prompt, max_new_tokens=8)
    out = ep.run()
    assert ep.pool.cow_copies >= 1         # replay regime: COW taken
    intact()
    cows = ep.pool.cow_copies
    assert ep.pool.cached_next_token(prompt) is not None
    rc = ep.submit(prompt, max_new_tokens=8)
    out2 = ep.run()
    assert ep.pool.cow_copies == cows      # fast path: no new COW
    assert out2[rc] == out[rb]
    intact()


def test_int8_pages_raise_the_reference_error_for_mla():
    _, params, np_params = _weights()
    with pytest.raises(ValueError, match="cannot quantize MLA latent pages"
                       r".*kv_dtype='fp32' with attn_kind='mla'"):
        ServingEngine(port_get_config(ARCH, smoke=True),
                      ServeConfig(kv_dtype="int8"),
                      params=from_jax_params(np_params), device="cpu")
