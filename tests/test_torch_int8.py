"""The port's int8 KV pages against the JAX package, on the CPU.

``kv_dtype="int8"`` stores per-head k/v pages as int8 rows with one bf16
scale per (page, offset, kv-head) row, for qwen's contiguous pages and
mixtral's ring pages.  Held against the JAX package on the same numpy
inputs or the same weights (``from_jax_params``):

  * ``quantize_kv``: int8 values and bf16 scales bit for bit;
  * ``quantized_layout`` / ``layout_for`` and the pool's page template
    (leaves, dtypes, shapes) and page bytes;
  * the quantize-on-write page updates (decode append, prefill scatter,
    ring cells) bit for bit;
  * the plain K8 branches of K1, K2, K4 and K5 against the JAX oracles and
    the Pallas kernels in interpret mode (``tests/test_paged_attention.py``'s
    quantized grids);
  * engine streams of qwen and mixtral on int8 pages against the JAX int8
    engine, kernels off and on, cold and warm; int8 kernel on == off; page
    bytes under the reference's 0.30x budget; a ``kv_dtype`` switch drops
    the stale engine.

Tolerances: plain K8 against the oracles 2e-5 (fp32; the same fused
dequant, another order of sums) and 1e-2 in bf16; pages and token streams
exact.
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
from repro.models import attention as jax_attn
from repro.models import registry as jax_registry
from repro.serving import ServingEngine as JaxEngine
from repro.serving import layouts as jax_layouts
from repro_torch import api as port_api
from repro_torch.configs import ServeConfig
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.paged_attention import ops as port_ops
from repro_torch.models import attention as port_attn
from repro_torch.models import registry as port_registry
from repro_torch.serving import layouts as port_layouts
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paged import PagedKVCachePool

ARCHS = {"full": "qwen2.5-14b", "swa": "mixtral-8x22b"}
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x)).to(TORCH[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(x).astype(JNP[dtype])


def _bits(x):
    """A tensor or array as raw integers (bf16 as its 16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


# ---------------------------------------------------------------------------
# The quantizer and the layout seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_quantize_kv_bit_for_bit(scale, dtype):
    """Values and bf16 scales equal the JAX quantizer's bit for bit: the
    scale rounds to bf16 before the divide, rounding is half to even, the
    clip holds the ratio at 127; an all-zero row takes scale 1."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 8, 4, 32)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3, :4] = [scale, -scale, 0.5 * scale, -127.5 / 127 * scale]
    q, s = port_layouts.quantize_kv(_t(x, dtype))
    jq, js = jax_layouts.quantize_kv(_j(x, dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    assert int(q.abs().max()) <= 127 and float(s[0, 0, 0]) == 1.0


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_quantized_layout_and_page_template_match_jax(kind):
    cfg = get_config(ARCHS[kind], smoke=True)
    pcfg = port_get_config(ARCHS[kind], smoke=True)
    lay = port_layouts.layout_for(pcfg, "int8")
    ref = jax_layouts.layout_for(cfg, "int8")
    assert (lay.name, lay.leaves, lay.window, lay.kv_dtype) == \
        (ref.name, ref.leaves, ref.window, ref.kv_dtype)
    assert lay.quantized and lay.data_leaves == ("k", "v")
    base = port_layouts.layout_for(pcfg)
    assert port_layouts.quantized_layout(base, "fp32") is base
    assert port_layouts.quantized_layout(base, "int8") == lay
    jb = jax_registry.build(cfg)
    pb = port_registry.build(pcfg)
    one = lay.page_template(pb.init_decode_state(1, 4, device="meta"))
    jone = ref.page_template(jb.init_decode_state(1, 4))
    assert sorted(one) == sorted(jone)
    for n in one:
        assert tuple(one[n].shape) == jone[n].shape
        assert str(one[n].dtype).split(".")[-1] == str(jone[n].dtype)


def test_int8_rejected_for_mla_and_slotted_with_the_reference_errors():
    ds = port_get_config("deepseek-v2-lite-16b", smoke=True)
    with pytest.raises(ValueError, match="mla"):
        port_layouts.layout_for(ds, "int8")
    with pytest.raises(ValueError, match="slotted"):
        ServeConfig(kv_dtype="int8", kv_layout="slotted")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeConfig(kv_dtype="fp8")


# ---------------------------------------------------------------------------
# Quantize-on-write page updates
# ---------------------------------------------------------------------------

def _int8_pages(P, ps, KV, hd):
    return ({"k": torch.zeros((P, ps, KV, hd), dtype=torch.int8),
             "v": torch.zeros((P, ps, KV, hd), dtype=torch.int8),
             "k_scale": torch.zeros((P, ps, KV), dtype=torch.bfloat16),
             "v_scale": torch.zeros((P, ps, KV), dtype=torch.bfloat16)},
            {"k": jnp.zeros((P, ps, KV, hd), jnp.int8),
             "v": jnp.zeros((P, ps, KV, hd), jnp.int8),
             "k_scale": jnp.zeros((P, ps, KV), jnp.bfloat16),
             "v_scale": jnp.zeros((P, ps, KV), jnp.bfloat16)})


def _assert_pages_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for n in port:
        np.testing.assert_array_equal(_bits(port[n]), _bits(ref[n]))


@pytest.mark.parametrize("window", [0, 8])
def test_int8_page_writes_match_jax_bit_for_bit(window):
    """A prefill chunk (wrapping the ring when ``window``) then a decode
    append, quantized on write: pages and scales equal the JAX writes'."""
    rng = np.random.default_rng(1)
    P, ps, KV, hd, S = 7, 4, 2, 16, 8
    port, ref = _int8_pages(P, ps, KV, hd)
    table = np.asarray([3, 5, 1, 6], np.int32)
    k = rng.normal(size=(1, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(1, S, KV, hd)).astype(np.float32)
    for start, n_valid in ((0, 6), (6, 5)):
        port = port_attn.paged_prefill_write(
            port, _t(k), _t(v), torch.from_numpy(table), start, n_valid,
            window=window)
        ref = jax_attn.paged_prefill_write(
            ref, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), start,
            n_valid, window=window)
        _assert_pages_equal(port, ref)
    kn = rng.normal(size=(2, 1, KV, hd)).astype(np.float32)
    vn = rng.normal(size=(2, 1, KV, hd)).astype(np.float32)
    tables = np.stack([table, np.asarray([2, 4, 0, 0], np.int32)])
    pos = np.asarray([11, 5], np.int32)
    port = port_attn.paged_cache_update(port, _t(kn), _t(vn),
                                        torch.from_numpy(tables),
                                        torch.from_numpy(pos), window=window)
    ref = jax_attn.paged_cache_update(ref, jnp.asarray(kn), jnp.asarray(vn),
                                      jnp.asarray(tables), jnp.asarray(pos),
                                      window=window)
    _assert_pages_equal(port, ref)


# ---------------------------------------------------------------------------
# K8: the int8 branches of K1 / K4 (decode), K2 and K5 (prefill), plain
# ---------------------------------------------------------------------------

def _quantized(x):
    q, s = jax_layouts.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _decode_case(seed, slots, H, KV, hd, ps, n):
    rng = np.random.default_rng(seed)
    P = slots * n + 1
    q = rng.normal(size=(slots, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    lengths = np.asarray(rng.integers(1, 2 * n * ps, size=slots), np.int32)
    lengths[0] = ps + 1                        # a straddling page
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s in range(slots):
        for i in range(min(n, -(-int(lengths[s]) // ps))):
            table[s, i] = pid
            pid += 1
    return q, k, v, table, lengths


#: tests/test_paged_attention.py PAGED_CASES[:2] x {full, ring} and a GQA
#: group of 6 (mixtral's), in fp32 and bf16
INT8_DECODE_CASES = [
    (3, 4, 2, 32, 8, 4), (2, 8, 8, 16, 4, 3), (3, 6, 1, 64, 16, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
@pytest.mark.parametrize("case", INT8_DECODE_CASES)
def test_int8_decode_plain_matches_jax_ref_and_pallas(case, ring, dtype):
    slots, H, KV, hd, ps, n = case
    q, k, v, table, lengths = _decode_case(2, *case)
    window = n * ps if ring else 0
    if not ring:
        lengths = np.minimum(lengths, n * ps)
    kq, ks = _quantized(k)
    vq, vs = _quantized(v)
    got = port_ops.paged_attention(
        _t(q, dtype), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(table), torch.from_numpy(lengths), window=window,
        k_scale=_t(ks.astype(np.float32), "bfloat16"),
        v_scale=_t(vs.astype(np.float32), "bfloat16"), use_kernel=True)
    args = (_j(q, dtype), jnp.asarray(kq), jnp.asarray(vq), table, lengths)
    kw = dict(window=window, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = jax_ref.paged_attention_ref(*args, **kw)
    pallas = jax_ops.paged_attention(*args, **kw, use_kernel=True,
                                     interpret=True)
    for w in (want, pallas):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=TOL[dtype])


def _prefill_case(seed, H, KV, hd, ps, n, S):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, H, hd)).astype(np.float32)
    k = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    ck = rng.normal(size=(S, KV, hd)).astype(np.float32)
    cv = rng.normal(size=(S, KV, hd)).astype(np.float32)
    return q, k, v, ck, cv, np.arange(1, n + 1, dtype=np.int32)


#: tests/test_paged_attention.py PREFILL_CASES[:2] + [-1] (contiguous) and
#: RING_PREFILL_CASES (window = n * ps), as (ring, H, KV, hd, ps, n, S,
#: start, n_valid)
INT8_PREFILL_CASES = [
    (False, 4, 2, 32, 8, 4, 16, 0, 16),
    (False, 4, 2, 32, 8, 4, 16, 10, 13),
    (False, 4, 2, 32, 16, 7, 256, 0, 100),
    (False, 6, 1, 64, 8, 4, 5, 20, 3),
    (True, 4, 2, 32, 8, 3, 16, 0, 16),
    (True, 4, 2, 32, 8, 3, 16, 30, 13),
    (True, 8, 8, 16, 4, 4, 8, 10, 5),
    (True, 2, 1, 64, 8, 2, 32, 70, 27),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", INT8_PREFILL_CASES)
def test_int8_prefill_plain_matches_jax_ref_and_pallas(case, dtype):
    ring, H, KV, hd, ps, n, S, start, n_valid = case
    q, k, v, ck, cv, table = _prefill_case(3, H, KV, hd, ps, n, S)
    kq, ks = _quantized(k)
    vq, vs = _quantized(v)
    pk = dict(k_scale=_t(ks.astype(np.float32), "bfloat16"),
              v_scale=_t(vs.astype(np.float32), "bfloat16"))
    jk = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    if ring:
        got = port_ops.paged_ring_prefill(
            _t(q, dtype), torch.from_numpy(kq), torch.from_numpy(vq),
            _t(ck, dtype), _t(cv, dtype), torch.from_numpy(table), start,
            n_valid, window=n * ps, use_kernel=True, **pk)
        args = (_j(q, dtype), jnp.asarray(kq), jnp.asarray(vq),
                _j(ck, dtype), _j(cv, dtype), table, start, n_valid)
        want = jax_ref.paged_ring_prefill_ref(*args, window=n * ps, **jk)
        pallas = jax_ops.paged_ring_prefill(*args, window=n * ps,
                                            use_kernel=True, interpret=True,
                                            **jk)
    else:
        got = port_ops.paged_prefill(
            _t(q, dtype), torch.from_numpy(kq), torch.from_numpy(vq),
            torch.from_numpy(table), start, n_valid, use_kernel=True, **pk)
        args = (_j(q, dtype), jnp.asarray(kq), jnp.asarray(vq), table,
                start, n_valid)
        want = jax_ref.paged_prefill_ref(*args, **jk)
        pallas = jax_ops.paged_prefill(*args, use_kernel=True,
                                       interpret=True, **jk)
    for w in (want, pallas):
        np.testing.assert_allclose(got.float().numpy()[:n_valid],
                                   np.asarray(w, np.float32)[:n_valid],
                                   atol=TOL[dtype])


def test_int8_attention_tracks_fp():
    """The fused int8 path approximates fp attention on the pages it was
    quantized from, within int8 resolution (the reference's accuracy
    check, 0.05)."""
    q, k, v, table, lengths = _decode_case(4, 3, 4, 2, 32, 8, 4)
    lengths = np.minimum(lengths, 32)
    kq, ks = _quantized(k)
    vq, vs = _quantized(v)
    fp = port_ops.paged_attention(_t(q), _t(k), _t(v),
                                  torch.from_numpy(table),
                                  torch.from_numpy(lengths))
    qd = port_ops.paged_attention(
        _t(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(table), torch.from_numpy(lengths),
        k_scale=_t(ks.astype(np.float32), "bfloat16"),
        v_scale=_t(vs.astype(np.float32), "bfloat16"))
    torch.testing.assert_close(qd, fp, atol=0.05, rtol=0.05)


# ---------------------------------------------------------------------------
# The engine on int8 pages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = get_config(arch, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(3))
    return cfg, params, jax.tree.map(np.asarray, params)


def _knobs(**kw):
    base = dict(max_batch=2, max_seq_len=40, max_new_tokens=10,
                decode_steps=2, kv_layout="paged", kv_dtype="int8",
                page_size=4)
    base.update(kw)
    return base


def _port_engine(arch, **kw):
    _, _, np_params = _weights(arch)
    return ServingEngine(port_get_config(arch, smoke=True),
                         ServeConfig(**_knobs(**kw)),
                         params=from_jax_params(np_params), device="cpu")


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


#: prompts per arch; mixtral's 10-token streams wrap its window-8 ring in
#: decode, so decode writes rotate int8 cells
ENGINE_PROMPTS = {"full": [9, 14, 5, 12], "swa": [3, 4, 2, 4]}


def _jax_streams(cfg, params, batches, kernels):
    """The JAX int8 engine's streams for each batch in turn (one engine,
    so the second batch is warm), with its prefix-hit counts.  The JAX
    paged ring engine returns another stream now and then on the CPU
    backend (a reference-side flake, see ROADMAP); for the ring the
    reference is the run that two of up to three fresh runs agree on."""
    def run():
        je = JaxEngine(cfg, JaxServeConfig(**_knobs(), use_pallas=kernels),
                       params=params)
        outs = []
        for prompts in batches:
            outs.append((je.generate(prompts, 10),
                         je.metrics.prefix_hit_tokens))
        return outs
    if cfg.attn_kind != "swa":
        return run()
    runs = [run(), run()]
    if runs[0] != runs[1]:
        runs.append(run())
    return max(runs, key=runs.count)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_int8_engine_streams_match_jax_cold_and_warm(kind, kernels):
    """int8 greedy streams equal the JAX int8 engine's, cold, then warm
    (the same prompts again: prefix hits read the quantized pages)."""
    arch = ARCHS[kind]
    cfg, params, _ = _weights(arch)
    prompts = _prompts(5, ENGINE_PROMPTS[kind])
    prompts.append(list(prompts[0]))
    want = _jax_streams(cfg, params, [prompts, prompts], kernels)
    pe = _port_engine(arch, use_kernels=kernels)
    assert pe.layout.quantized and "k_scale" in pe.pool.pages
    assert pe.pool.pages["k"].dtype == torch.int8
    assert pe.pool.pages["k_scale"].dtype == torch.bfloat16
    for w in want:
        assert (pe.generate(prompts, 10), pe.metrics.prefix_hit_tokens) == w
    assert pe.metrics.prefix_hit_tokens > 0
    if kind == "swa":
        assert pe.pool.ring_rotations > 0
    assert pe.pool.pages_held == 0
    assert pe.pool.pages_allocated == pe.pool.pages_freed
    s = pe.metrics.summary()
    assert 0 < s["kv_bytes_peak"] <= s["kv_bytes_slotted"]


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_int8_kernel_on_equals_off(kind):
    """The fused dequant of the kernels' plain versions and of the gather
    path read the same quantized bytes: kernels on == off, with chunked
    prefills that wrap mixtral's ring, speculation and a warm repeat."""
    prompts = _prompts(6, [21, 9, 14]) + [[7, 3] * 8]
    prompts.append(list(prompts[0]))
    outs = [_port_engine(ARCHS[kind], use_kernels=k, prefill_chunk_tokens=4,
                         max_new_tokens=12).generate(prompts, 12)
            for k in (False, True)]
    assert outs[0] == outs[1]


def test_int8_page_bytes_under_the_reference_budget():
    """An int8 page (int8 rows + bf16 scales) costs what the JAX pool's
    does and at most 0.30x its fp32 equivalent ((16 + 2) / 64 = 0.28 at
    the smoke head dim 16); fp32 pools report a ratio of 1."""
    for kind, arch in sorted(ARCHS.items()):
        cfg, params, _ = _weights(arch)
        pool = _port_engine(arch).pool
        ref = JaxEngine(cfg, JaxServeConfig(**_knobs()), params=params).pool
        assert (pool.page_bytes, pool.page_bytes_fp32) == \
            (ref.page_bytes, ref.page_bytes_fp32)
        assert pool.page_bytes / pool.page_bytes_fp32 <= 0.30, kind
        fp = _port_engine(arch, kv_dtype="fp32").pool
        assert fp.page_bytes == fp.page_bytes_fp32
        assert isinstance(pool, PagedKVCachePool)


def test_session_kv_dtype_switch_drops_stale_engine():
    sess = port_api.load("qwen2.5-14b", smoke=True, device="cpu",
                         num_layers=2)
    prompt = list(range(4, 20))
    out8 = sess.generate(prompt, max_new=4, kv_layout="paged",
                         kv_dtype="int8")
    eng8 = sess.engine
    assert eng8.layout.quantized
    out32 = sess.generate(prompt, max_new=4, kv_layout="paged",
                          kv_dtype="fp32")
    assert eng8 not in sess._engines.values()
    assert not eng8.pool._index            # stale prefix cache cleared
    assert not sess.engine.layout.quantized
    assert len(out8) == len(out32) == 4
