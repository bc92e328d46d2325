"""K-EXAONE on the port: windowed and global layers side by side, the
sigmoid router over a held share of the experts, and the two-kind page
pool, held to the benchmark's plain float32 reference
(``bench/reference/exaone_moe.py``) at the smoke size on the CPU.

Logits are compared, never sampled tokens.  Tolerances: the program runs
in float32 here with the same operations as the reference in another
order (blocked online softmax against a full one, fused GQA against
repeated heads, a grouped expert sum), so their logits agree to float32
rounding: 1e-4 absolute on logits of size ~4, where a lost term (one
expert's part, one key of a window, a missing norm) moves them by 1e-2 or
more.

Also here: the new ``ModelConfig`` fields at their defaults leave the
existing families (qwen, deepseek, mixtral) as the JAX package has them —
parameter trees and greedy streams.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from bench.core.weights import make_weights, shape_mismatches
from bench.reference import exaone_moe as ref
from repro import api as jax_api
from repro.models import registry as jax_registry
from repro_torch import api as port_api
from repro_torch.configs import get_config
from repro_torch.configs import k_exaone_236b_a23b as kx
from repro_torch.convert import from_jax_params
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import attention as A
from repro_torch.models import moe as moe_mod
from repro_torch.models import registry
from repro_torch.models.transformer import lm_forward, lm_head
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.layouts import layout_for
from repro_torch.serving.paged import PagedKVCachePool

SHARE, WHOLE = kx.SHARE_ID, kx.ARCH_ID
TOL = dict(rtol=1e-4, atol=1e-4)


def hf_config(mc) -> dict:
    """The smoke configuration in the reference's (Hugging Face) keys —
    written here: the benchmark's smoke helper maps this family to no
    reference."""
    L = mc.num_layers
    return {"hidden_size": mc.d_model, "num_hidden_layers": L,
            "num_attention_heads": mc.num_heads,
            "num_key_value_heads": mc.num_kv_heads,
            "head_dim": mc.resolved_head_dim,
            "intermediate_size": mc.d_ff_dense,
            "moe_intermediate_size": mc.moe.d_ff_expert,
            "num_experts": mc.moe.held, "router_experts": mc.moe.num_experts,
            "num_experts_per_tok": mc.moe.top_k,
            "num_shared_experts": mc.moe.num_shared_experts,
            "routed_scaling_factor": mc.moe.routed_scaling,
            "layer_types": ["full_attention" if mc.layer_kind(i) == "G"
                            else "sliding_attention" for i in range(L)],
            "mlp_layer_types": ["dense" if i < mc.first_dense_layers
                                else "sparse" for i in range(L)],
            "sliding_window": mc.window,
            "rope_parameters": {"rope_theta": mc.rope_theta},
            "rms_norm_eps": mc.norm_eps, "vocab_size": mc.vocab_size}


def _setup(arch=SHARE, seed=1234):
    mc = get_config(arch, smoke=True)
    cfg = hf_config(mc)
    bundle = registry.build(mc)
    shapes = ref.param_shapes(cfg)
    assert shape_mismatches(shapes, bundle.specs) == []
    w = make_weights(shapes, ref.leaf_std, seed, "cpu", torch.float32)
    return mc, cfg, bundle, w


def _tokens(seed, n, vocab=256):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=g).tolist()


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

def test_configs_hold_the_published_shape():
    whole, share = get_config(WHOLE), get_config(SHARE)
    assert registry.count_params(whole) == 236_571_156_352
    assert registry.count_params(share) == 23_668_285_312
    assert [share.layer_kind(i) for i in range(48)].count("G") == 12
    assert share.moe.held == 8 and share.moe.num_experts == 128
    assert whole.moe.held == 128
    specs = registry.build(share).specs
    assert specs["layers"]["ff"]["w_gate"].shape == (47, 8, 6144, 2048)
    assert specs["layers"]["ff"]["router"].shape == (47, 6144, 128)
    assert specs["dense_layers"]["ff"]["w_gate"].shape == (1, 6144, 18432)


@pytest.mark.parametrize("arch", [SHARE, WHOLE])
def test_lm_forward_matches_reference(arch):
    mc, cfg, _, w = _setup(arch)
    seqs = [_tokens(5, 37), _tokens(6, 64)]
    got = ref.logits_at(cfg, w, seqs, [list(range(len(s))) for s in seqs])
    for s, r in zip(seqs, got):
        x, _, _ = lm_forward(mc, w, torch.tensor([s]), collect_cache=True,
                             cache_len=len(s), moe_dropless=True)
        torch.testing.assert_close(lm_head(mc, w, x)[0].float(), r, **TOL)


def _paged_logits(mc, bundle, w, seq, prompt_len, chunk, ps=4):
    """Chunked prefill of ``seq[:prompt_len]`` (``chunk`` tokens a chunk,
    padded to ``chunk``) into a two-kind pool, then decode of the rest
    teacher-forced; the logits at positions prompt_len - 1 .. len - 1."""
    pool = PagedKVCachePool(3, ps, 128, lambda: bundle.init_decode_state(
        1, ps, device="meta"), layout=layout_for(mc))
    slot, _ = pool.alloc_prefix(0, seq[:prompt_len])
    assert slot == 0
    for st in range(0, prompt_len, chunk):
        n = min(chunk, prompt_len - st)
        toks = torch.zeros((1, chunk), dtype=torch.int32)
        toks[0, :n] = torch.tensor(seq[st:st + n])
        assert pool.prepare_chunk(slot, st, st + n - 1)
        lg, _ = bundle.paged_prefill_fn(
            w, toks, {"pages": pool.pages, **pool.chunk_tables(slot),
                      "start": st, "n_valid": n})
    out = [lg[0]]
    for t in range(prompt_len, len(seq)):
        assert not pool.ensure_decode_capacity(steps={slot: 1})
        tables, pos, _ = pool.unpack_operands(pool.decode_operands({slot: 1}))
        toks = torch.zeros((3, 1), dtype=torch.int64)
        toks[slot, 0] = seq[t]
        lg, _ = bundle.paged_decode_fn(w, toks, {"pages": pool.pages,
                                                 **tables, "pos": pos})
        out.append(lg[slot])
        pool.advance(steps={slot: 1})
    return torch.stack(out).float()


@pytest.mark.parametrize("prompt_len,chunk", [(77, 32), (30, 16), (5, 32)])
def test_paged_chunks_then_decode_match_reference(prompt_len, chunk):
    """Chunks longer than the window (8), a last chunk padded to its
    bucket, then decode steps well past the window, through the two-kind
    pool, against the reference's full forward."""
    mc, cfg, bundle, w = _setup(seed=99)
    seq = _tokens(7, prompt_len + 13)
    r = ref.logits_at(cfg, w, [seq], [list(range(prompt_len - 1,
                                                 len(seq)))])[0]
    torch.testing.assert_close(
        _paged_logits(mc, bundle, w, seq, prompt_len, chunk), r, **TOL)


def test_engine_serves_the_reference_stream():
    """``Session.serve`` through the paged engine (chunks of 32 over a
    window of 8, a pipelined decode of 4 steps) emits the reference's
    best token wherever the reference's top two logits are apart."""
    mc, cfg, _, w = _setup(seed=7)
    sess = port_api.load(SHARE, smoke=True, device="cpu")
    sess.set_params(w)
    prompts = [_tokens(11, 70), _tokens(12, 9), _tokens(13, 41)]
    outs = sess.serve(prompts, max_new=12, prefill_chunk_tokens=32,
                      page_size=4, max_batch=4, max_seq_len=128)
    eng = sess.engine
    assert eng.pool.ring_width == 2 and not eng.pool.enable_prefix_cache
    seqs = [p + o[:-1] for p, o in zip(prompts, outs)]
    want = [range(len(p) - 1, len(p) - 1 + len(o))
            for p, o in zip(prompts, outs)]
    checked = 0
    for lg, o in zip(ref.logits_at(cfg, w, seqs, want), outs):
        top2 = lg.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        best = lg.argmax(dim=-1)
        assert torch.equal(best[clear], torch.tensor(o)[clear])
        checked += int(clear.sum())
    assert checked > 30
    s = eng.metrics.summary()
    assert s["ring_cells"] == 3 * eng.pool.ring_width
    assert s["global_pages_peak"] > 0 and s["moe_held_picks"] > 0


# ---------------------------------------------------------------------------
# The sliding mask at the ring's boundaries
# ---------------------------------------------------------------------------

def _naive(q, k, v, qpos, window):
    """exaone4's masks written out: key j is seen by query i when
    i - window < j <= i.  q [S, H, hd]; k, v [T, KV, hd] at positions
    0 .. T - 1."""
    G = q.shape[1] // k.shape[1]
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = torch.einsum("shd,thd->hst", q, kk) * q.shape[-1] ** -0.5
    kpos = torch.arange(k.shape[0])
    seen = (kpos[None] <= qpos[:, None]) & (kpos[None] > qpos[:, None]
                                            - window)
    s = s.masked_fill(~seen[None], float("-inf"))
    return torch.einsum("hst,thd->shd", torch.softmax(s, -1), vv)


@pytest.mark.parametrize("chunks", [
    [(0, 20)],                  # a first chunk longer than the window
    [(0, 5), (5, 6)],           # the second chunk wraps the ring mid-chunk
    [(0, 3), (3, 19), (22, 2)],  # a long chunk over a short history
])
def test_sliding_mask_at_ring_boundaries(chunks):
    """Ring prefill (snapshot before write, only a chunk's last window
    keys written) and then decode steps just past the window read exactly
    the keys exaone4's sliding mask keeps."""
    window, ps, KV, G, hd = 8, 4, 2, 2, 16
    g = torch.Generator().manual_seed(3)
    T = chunks[-1][0] + chunks[-1][1] + window + 2
    q = torch.randn(T, KV * G, hd, generator=g)
    k = torch.randn(T, KV, hd, generator=g)
    v = torch.randn(T, KV, hd, generator=g)
    pages = {"k": torch.zeros(1 + window // ps, ps, KV, hd),
             "v": torch.zeros(1 + window // ps, ps, KV, hd)}
    row = torch.arange(1, 1 + window // ps, dtype=torch.int32)
    for start, n in chunks:
        S = 32                                  # the chunk's padded bucket
        qc = torch.zeros(S, KV * G, hd)
        kc, vc = torch.zeros(S, KV, hd), torch.zeros(S, KV, hd)
        qc[:n], kc[:n], vc[:n] = (q[start:start + n], k[start:start + n],
                                  v[start:start + n])
        out = pa_ops.paged_ring_prefill(qc, pages["k"], pages["v"], kc, vc,
                                        row, start, n, window=window)
        A.paged_prefill_write(pages, kc[None], vc[None], row, start, n,
                              window=window)
        want = _naive(q[start:start + n], k, v,
                      torch.arange(start, start + n), window)
        torch.testing.assert_close(out[:n], want, rtol=1e-5, atol=1e-5)
    # decode: one query a step, at lengths up to two past the window
    for t in range(chunks[-1][0] + chunks[-1][1], T):
        A.paged_cache_update(pages, k[t][None, None], v[t][None, None],
                             row[None], torch.tensor([t]), window=window)
        out = pa_ops.paged_attention(q[t][None], pages["k"], pages["v"],
                                     row[None], torch.tensor([t + 1]),
                                     window=window)
        want = _naive(q[t][None], k, v, torch.tensor([t]), window)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The router and the held share
# ---------------------------------------------------------------------------

def test_choice_with_bias_gate_without_bias():
    """The bias moves the choice and never the gates: picks are the top-k
    of score + bias, gates the picks' scores normalised and scaled by
    2.5, as the reference's router computes them."""
    mc = get_config(SHARE, smoke=True)
    m = mc.moe
    g = torch.Generator().manual_seed(4)
    x = torch.randn(40, mc.d_model, generator=g)
    p = {"router": torch.randn(mc.d_model, m.num_experts, generator=g) / 8,
         "e_score_correction_bias": torch.randn(m.num_experts,
                                                generator=g) * 0.3}
    _, gates, sel = moe_mod.route(m, p, x)
    scores = torch.sigmoid(x @ p["router"])
    want_sel = torch.sort(scores + p["e_score_correction_bias"], dim=-1,
                          descending=True, stable=True)[1][:, :m.top_k]
    assert torch.equal(sel, want_sel)
    # the bias changed some choice, and the gates ignore it
    plain = torch.sort(scores, -1, descending=True)[1][:, :m.top_k]
    assert not torch.equal(sel.sort(-1)[0], plain.sort(-1)[0])
    picked = scores.gather(1, sel)
    torch.testing.assert_close(
        gates, 2.5 * picked / (picked.sum(-1, keepdim=True) + 1e-20))
    rg, rsel = ref.route({"routed_scaling_factor": 2.5},
                         {"K": m.top_k}, p, x, "fp32")
    assert torch.equal(rsel, sel)
    torch.testing.assert_close(rg, gates)


@pytest.mark.parametrize("dense", [False, True])
def test_share_parts_add_up_to_the_uncut_layer(monkeypatch, dense):
    """The 16 shares' routed parts (each share's experts at its own
    offset, through the expert-parallel ``first`` / ``n_local`` bounds),
    plus the shared expert counted once, equal the uncut reference's MoE
    layer — on the sorted route and on the dense decode route."""
    share = get_config(SHARE, smoke=True)
    whole = get_config(WHOLE, smoke=True)
    m, n = share.moe, share.moe.held
    assert m.num_experts // n == kx.EP_CARDS
    _, cfg, _, w = _setup(WHOLE, seed=21)
    p = {k: v[2] for k, v in w["layers"]["ff"].items() if k != "shared"}
    p["shared"] = {k: v[2] for k, v in w["layers"]["ff"]["shared"].items()}
    g = torch.Generator().manual_seed(8)
    x = torch.randn(1, 24, whole.d_model, generator=g) * 3
    shared = moe_mod._expert(torch.nn.functional.silu,
                             p["shared"]["w_gate"], p["shared"]["w_up"],
                             p["shared"]["w_down"], x, x.dtype)
    total = shared.clone()
    for s in range(kx.EP_CARDS):
        monkeypatch.setattr(moe_mod, "local_offset",
                            lambda _n, _axis, s=s: s * n)
        ps = {**p, **{k: p[k][s * n:(s + 1) * n]
                      for k in ("w_gate", "w_up", "w_down")}}
        y, _ = moe_mod.moe_apply(share, ps, x, per_token=True, dense=dense)
        total += y - shared
    want = ref.moe(cfg, ref.dims(cfg), p, x[0], "fp32")
    torch.testing.assert_close(total[0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dense", [False, True])
def test_router_and_held_count_never_read_the_host(dense):
    """Sigmoid routing, the held experts' mask and its device counter, on
    the sorted route (a masked bucket tail included) and the dense decode
    route: no host read and no data-shaped op."""
    from test_torch_decode_graphs import NoSync
    mc, _, _, w = _setup(seed=5)
    p = {k: v[1] for k, v in w["layers"]["ff"].items() if k != "shared"}
    p["shared"] = {k: v[1] for k, v in w["layers"]["ff"]["shared"].items()}
    x = torch.randn(1, 6, mc.d_model,
                    generator=torch.Generator().manual_seed(1))
    before = moe_mod.held_picks()
    with NoSync() as mode:
        moe_mod.moe_apply(mc, p, x, n_valid=4, per_token=True, dense=dense)
    assert mode.ops > 0
    _, _, sel = moe_mod.route(mc.moe, p, x[0, :4])
    assert moe_mod.held_picks() - before == int((sel < mc.moe.held).sum())


# ---------------------------------------------------------------------------
# What the two-kind pool does not have yet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob,value,names", [
    ("enable_prefix_cache", True, "enable_prefix_cache"),
    ("enable_spec", True, "enable_spec"),
    ("kv_dtype", "int8", "kv_dtype='int8'"),
])
def test_two_kind_pool_refuses_what_it_lacks(knob, value, names):
    from repro_torch.configs.base import ServeConfig
    kw = dict(enable_prefix_cache=False, enable_spec=False, page_size=4,
              max_seq_len=64, max_batch=2)
    kw[knob] = value
    with pytest.raises(ValueError, match=names) as e:
        ServingEngine(get_config(SHARE, smoke=True), ServeConfig(**kw),
                      device="cpu")
    assert "hybrid" in str(e.value)


# ---------------------------------------------------------------------------
# The new fields' defaults leave the existing families as they were
# ---------------------------------------------------------------------------

FAMILIES = ["qwen2.5-14b", "deepseek-v2-lite-16b", "mixtral-8x22b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_defaults_leave_parameter_trees_as_they_were(arch):
    mc = get_config(arch, smoke=True)
    assert (mc.layer_pattern, mc.qk_norm, mc.norm_placement,
            mc.rope_layers, mc.first_dense_layers, mc.d_ff_dense) == \
        ("", False, "pre", "all", 0, 0)
    assert (mc.moe is None or (mc.moe.scoring, mc.moe.correction_bias,
                               mc.moe.routed_scaling, mc.moe.experts_held)
            == ("softmax", False, 1.0, 0))
    from repro.configs import get_config as jax_config
    jspecs = jax_registry.build(jax_config(arch, smoke=True)).specs
    pspecs = registry.build(mc).specs
    flat = lambda t, p=(): ({p: tuple(t.shape)} if not isinstance(t, dict)
                            else {k: v for kk in t for k, v in
                                  flat(t[kk], p + (kk,)).items()})
    assert flat(pspecs) == flat(jspecs)


@functools.lru_cache(maxsize=None)
def _jax_session(arch):
    return jax_api.load(arch, smoke=True, seed=3)


def _jax_greedy(js, prompt, n):
    """The JAX package's greedy stream by a whole forward a token (no cache,
    no serving engine): what the port's engine has to reproduce."""
    from repro.models import transformer as jax_transformer
    seq = list(prompt)
    for _ in range(n):
        logits, _ = jax_transformer.lm_prefill(
            js.model, js.params, jax.numpy.asarray([seq]), moe_dropless=True)
        seq.append(int(jax.numpy.argmax(logits[0])))
    return seq[len(prompt):]


@pytest.mark.parametrize("arch", FAMILIES)
def test_defaults_leave_greedy_streams_as_they_were(arch):
    js = _jax_session(arch)
    ps = port_api.load(arch, smoke=True, device="cpu")
    ps.set_params(from_jax_params(jax.tree.map(np.asarray, js.params)))
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (9, 21)]
    got = ps.serve(prompts, max_new=8, prefill_chunk_tokens=8)
    assert got == [_jax_greedy(js, p, 8) for p in prompts]
