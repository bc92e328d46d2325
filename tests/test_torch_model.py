"""The port's decoders against the JAX package, on the same weights: the
dense family and deepseek-v2-lite (MLA attention + MoE feed-forward).

Weights come from the JAX ``bundle.init_params`` (threefry) and are carried
across with ``repro_torch.convert.from_jax_params``; both packages run the
smoke configs in fp32 (``compute_dtype="float32"``), the JAX side on its
``use_pallas=False`` path.  Tolerances: logits atol 1e-4 (fp32 through a
3-layer stack, summation order differs), loss 1e-5, page contents 1e-5;
greedy tokens must be identical.  MLA's paged paths run with the kernels
off (``use_kernels`` / ``use_pallas`` False: expanded prefill) and on (both
True: absorbed prefill through K7's plain version and the Pallas kernel in
interpret mode).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import registry as jax_registry
from repro.models import transformer as jt
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import transformer as pt

DENSE = ["qwen2.5-14b", "stablelm-1.6b"]
MLA = "deepseek-v2-lite-16b"
ARCHS = DENSE + [MLA]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_config(arch, smoke=True)
    assert cfg.compute_dtype == "float32"
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(7))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, port_get_config(arch, smoke=True), np_params


def _port_params(np_params):
    return from_jax_params(np_params)


def _np(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_logits_match(arch):
    cfg, params, pcfg, np_params = _setup(arch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    x, _, _ = jt.lm_forward(cfg, params, jnp.asarray(tokens, jnp.int32))
    want = np.asarray(jt.lm_head(cfg, params, x))
    pp = _port_params(np_params)
    px, _, _ = pt.lm_forward(pcfg, pp, torch.from_numpy(tokens))
    got = _np(pt.lm_head(pcfg, pp, px))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches(arch):
    cfg, params, pcfg, np_params = _setup(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    labels[0, :3] = -100                              # masked positions
    want = float(jt.lm_loss(cfg, params, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)}))
    got = float(pt.lm_loss(pcfg, _port_params(np_params),
                           {"tokens": torch.from_numpy(tokens),
                            "labels": torch.from_numpy(labels)}))
    assert abs(got - want) < 1e-5, (got, want)


def _pages(cfg, n_pages, ps):
    shape = (cfg.num_layers, n_pages, ps, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}


@pytest.mark.parametrize("arch", DENSE)
def test_paged_prefill_verify_decode_match(arch):
    """Two prefill chunks (the second after the first's prefix), a verify
    row and a batched decode step, on the same page table and positions:
    logits and every page equal the JAX gather path's."""
    cfg, params, pcfg, np_params = _setup(arch)
    pp = _port_params(np_params)
    ps, n = 4, 8
    rng = np.random.default_rng(2)
    pages = _pages(cfg, 2 * n + 1, ps)
    jpages = {k: jnp.asarray(v) for k, v in pages.items()}
    tpages = {k: torch.from_numpy(v.copy()) for k, v in pages.items()}
    row0 = np.arange(1, n + 1, dtype=np.int32)
    row0[6:] = 0                                      # trash-padded tail
    row1 = np.arange(n + 1, 2 * n + 1, dtype=np.int32)

    def check(j_logits, t_logits):
        np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits),
                                   atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tpages[name]),
                                       np.asarray(jpages[name]), atol=1e-5)

    # chunk 1: 13 real tokens in a 16-wide bucket; chunk 2 continues at 13
    for start, n_valid, width, fn_j, fn_t in (
            (0, 13, 16, jt.lm_paged_prefill, pt.lm_paged_prefill),
            (13, 5, 16, jt.lm_paged_prefill, pt.lm_paged_prefill),
            (18, 4, 5, jt.lm_paged_verify, pt.lm_paged_verify)):
        toks = np.zeros((1, width), np.int32)
        toks[0, :n_valid] = rng.integers(0, cfg.vocab_size, n_valid)
        j_logits, jpages = fn_j(cfg, params, jnp.asarray(toks),
                                {"pages": jpages,
                                 "page_table": jnp.asarray(row0),
                                 "start": start, "n_valid": n_valid})
        t_logits, tpages = fn_t(pcfg, pp, torch.from_numpy(toks),
                                {"pages": tpages,
                                 "page_table": torch.from_numpy(row0),
                                 "start": start, "n_valid": n_valid})
        check(j_logits, t_logits)

    # one batched decode step: slot 0 continues the request at 22, slot 1
    # holds 3 tokens of its own pages (never written: garbage-free zeros)
    table = np.stack([row0, row1])
    pos = np.asarray([22, 3], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    j_logits, jpages = jt.lm_paged_decode(
        cfg, params, jnp.asarray(toks),
        {"pages": jpages, "page_table": jnp.asarray(table),
         "pos": jnp.asarray(pos)})
    t_logits, tpages = pt.lm_paged_decode(
        pcfg, pp, torch.from_numpy(toks),
        {"pages": tpages, "page_table": torch.from_numpy(table),
         "pos": torch.from_numpy(pos)})
    check(j_logits, t_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_greedy_16_steps_identical(arch):
    """Whole-prompt prefill into ring caches, then 16 greedy decode steps:
    the token streams are identical."""
    cfg, params, pcfg, np_params = _setup(arch)
    pp = _port_params(np_params)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               (1, 9)).astype(np.int32)
    cache_len = 32
    j_logits, jc = jt.lm_prefill(cfg, params, jnp.asarray(prompt),
                                 cache_len=cache_len)
    t_logits, tc = pt.lm_prefill(pcfg, pp, torch.from_numpy(prompt),
                                 cache_len=cache_len)
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits),
                               atol=1e-4)
    step = jax.jit(functools.partial(jt.lm_decode, cfg))
    jtok = int(jnp.argmax(j_logits[0]))
    ttok = int(torch.argmax(t_logits[0]))
    j_out, t_out = [jtok], [ttok]
    for _ in range(16):
        j_logits, jc = step(params, jnp.asarray([[jtok]], jnp.int32), jc)
        t_logits, tc = pt.lm_decode(pcfg, pp, torch.tensor([[ttok]]), tc)
        jtok = int(jnp.argmax(j_logits[0]))
        ttok = int(torch.argmax(t_logits[0]))
        j_out.append(jtok)
        t_out.append(ttok)
    assert t_out == j_out


@pytest.mark.parametrize("kernels", [False, True], ids=["gather", "kernel"])
def test_mla_paged_prefill_verify_decode_match(kernels):
    """deepseek-v2-lite on latent pages: two prefill chunks, a verify row
    and a batched decode step; logits and every ckv / krope page equal the
    JAX package's with ``use_pallas`` = ``use_kernels``."""
    cfg, params, pcfg, np_params = _setup(MLA)
    pp = _port_params(np_params)
    m = cfg.mla
    ps, n = 8, 4
    rng = np.random.default_rng(2)
    pages = {"ckv": np.zeros((cfg.num_layers, 2 * n + 1, ps,
                              m.kv_lora_rank), np.float32),
             "krope": np.zeros((cfg.num_layers, 2 * n + 1, ps,
                                m.qk_rope_head_dim), np.float32)}
    jpages = {k: jnp.asarray(v) for k, v in pages.items()}
    tpages = {k: torch.from_numpy(v.copy()) for k, v in pages.items()}
    row0 = np.asarray([1, 2, 3, 0], np.int32)         # trash-padded tail
    row1 = np.arange(n + 1, 2 * n + 1, dtype=np.int32)

    def check(j_logits, t_logits):
        np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits),
                                   atol=1e-4)
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(_np(tpages[name]),
                                       np.asarray(jpages[name]), atol=1e-5)

    for start, n_valid, width, fn_j, fn_t in (
            (0, 13, 16, jt.lm_paged_prefill, pt.lm_paged_prefill),
            (13, 5, 16, jt.lm_paged_prefill, pt.lm_paged_prefill),
            (18, 4, 5, jt.lm_paged_verify, pt.lm_paged_verify)):
        toks = np.zeros((1, width), np.int32)
        toks[0, :n_valid] = rng.integers(0, cfg.vocab_size, n_valid)
        j_logits, jpages = fn_j(cfg, params, jnp.asarray(toks),
                                {"pages": jpages,
                                 "page_table": jnp.asarray(row0),
                                 "start": start, "n_valid": n_valid},
                                use_pallas=kernels)
        t_logits, tpages = fn_t(pcfg, pp, torch.from_numpy(toks),
                                {"pages": tpages,
                                 "page_table": torch.from_numpy(row0),
                                 "start": start, "n_valid": n_valid},
                                use_kernels=kernels)
        if fn_t is pt.lm_paged_verify:                # padding rows: unread
            j_logits, t_logits = j_logits[:n_valid], t_logits[:n_valid]
        check(j_logits, t_logits)

    table = np.stack([row0, row1])
    pos = np.asarray([22, 3], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    j_logits, jpages = jt.lm_paged_decode(
        cfg, params, jnp.asarray(toks),
        {"pages": jpages, "page_table": jnp.asarray(table),
         "pos": jnp.asarray(pos)}, use_pallas=kernels)
    t_logits, tpages = pt.lm_paged_decode(
        pcfg, pp, torch.from_numpy(toks),
        {"pages": tpages, "page_table": torch.from_numpy(table),
         "pos": torch.from_numpy(pos)}, use_kernels=kernels)
    check(j_logits, t_logits)


def test_mla_prefill_cache_holds_the_latents():
    """lm_prefill's ring cache for MLA holds the latent leaves (ckv, krope)
    at the JAX package's values, with a masked bucket tail."""
    cfg, params, pcfg, np_params = _setup(MLA)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               (1, 16)).astype(np.int32)
    j_logits, jc = jt.lm_prefill(cfg, params, jnp.asarray(tokens),
                                 cache_len=24, n_valid=11, moe_dropless=True)
    t_logits, tc = pt.lm_prefill(pcfg, _port_params(np_params),
                                 torch.from_numpy(tokens), cache_len=24,
                                 n_valid=11, moe_dropless=True)
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits),
                               atol=1e-4)
    assert set(tc) == set(jc) == {"ckv", "krope", "pos", "index"}
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), atol=1e-5)
    for k in ("pos", "index"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


def test_mla_absorbed_and_expanded_prefill_agree_in_fp32():
    """The two MLA prefill formulations behind ``use_kernels`` — absorbed
    (K7's plain version on the CPU) and expanded — compute one function:
    in fp32 their logits agree to 1e-4 on a chunk after a cached prefix."""
    cfg, params, pcfg, np_params = _setup(MLA)
    pp = _port_params(np_params)
    m = cfg.mla
    out = {}
    for kernels in (False, True):
        pages = {"ckv": torch.zeros((cfg.num_layers, 5, 8, m.kv_lora_rank)),
                 "krope": torch.zeros((cfg.num_layers, 5, 8,
                                       m.qk_rope_head_dim))}
        row = torch.arange(1, 5, dtype=torch.int32)
        rng = np.random.default_rng(6)
        for start, n_valid in ((0, 11), (11, 9)):
            toks = np.zeros((1, 16), np.int32)
            toks[0, :n_valid] = rng.integers(0, cfg.vocab_size, n_valid)
            logits, pages = pt.lm_paged_verify(
                pcfg, pp, torch.from_numpy(toks),
                {"pages": pages, "page_table": row, "start": start,
                 "n_valid": n_valid}, use_kernels=kernels)
        out[kernels] = logits[:n_valid]
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=1e-4)
