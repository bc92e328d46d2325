"""The port's serving stack against the JAX engine, end to end on the CPU.

Greedy streams from ``repro_torch.api`` ``Session.serve`` must equal the
JAX ``Session.serve`` streams on the same weights (carried across with
``from_jax_params``) and prompts: cold, with a warm prefix-cache hit, with
speculation on and off, and with chunked prefill.  Sampled rows draw
JAX's threefry bits (``tests/test_torch_sampling.py`` holds them and the
sampled streams to the JAX package's); here they are also held to the
purity rows of ``tests/test_sampling.py``: a request's tokens are a pure
function of (prompt, SamplingParams) whatever the batch, pipeline depth,
cache warmth, speculation or preemption.
deepseek-v2-lite (MLA on latent pages + per-token MoE) is held to the JAX
engine with the kernels off (``use_kernels`` / ``use_pallas`` False: the
expanded MLA prefill) and on (both True: the absorbed prefill, through
K6/K7's plain versions here and the Pallas kernels in interpret mode
there).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro_torch import api as port_api
from repro_torch.convert import from_jax_params
from repro_torch.serving import GREEDY, SamplingParams
from repro_torch.serving.sampling import (pack_params, sample_tokens,
                                         threefry2x32)
from repro_torch.serving.spec import NGramDrafter

ARCH = "qwen2.5-14b"
MLA = "deepseek-v2-lite-16b"
SAMPLED = SamplingParams(temperature=0.8, top_k=8, top_p=0.9, seed=13)


@functools.lru_cache(maxsize=None)
def _jax_session(arch=ARCH):
    return jax_api.load(arch, smoke=True, seed=3)


def _port_session(arch=ARCH):
    sess = port_api.load(arch, smoke=True, device="cpu")
    sess.set_params(from_jax_params(jax.tree.map(np.asarray,
                                                 _jax_session(arch).params)))
    return sess


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _rep_prompt(n=12, a=7, b=3):
    """A repetitive prompt the n-gram drafter can always propose from."""
    return ([a, b] * n)[:n]


# ---------------------------------------------------------------------------
# Port == JAX, greedy
# ---------------------------------------------------------------------------

def _serve_both(batches, arch=ARCH, jax_kw=(), port_kw=(), **kw):
    """Serve each batch in turn on one JAX and one port session (the
    second batch sees the first's warm prefix cache); returns the streams
    and the last engines' metrics.  ``jax_kw`` / ``port_kw`` hold knobs
    only one side takes (JAX ``use_pallas``, the port's ``use_kernels``)."""
    js, ps = _jax_session(arch), _port_session(arch)
    out = []
    for prompts in batches:
        j = js.serve(prompts, **kw, **dict(jax_kw))
        p = ps.serve(prompts, **kw, **dict(port_kw))
        out.append((j, p))
    return out, js.engine.metrics, ps.engine.metrics


SERVE_CASES = {
    "cold": dict(batches=[_prompts(0, [9, 17, 5, 12])], kw=dict(max_new=10)),
    "warm_prefix": dict(
        batches=[_prompts(1, [20, 7]),
                 [_prompts(1, [20])[0] + [1, 2, 3],
                  _prompts(1, [20])[0][:16] + [9, 9],
                  _prompts(2, [6])[0]]],
        kw=dict(max_new=8, page_size=4, max_batch=4)),
    "spec_on": dict(batches=[[_rep_prompt(12), _prompts(3, [9])[0],
                              _rep_prompt(16, 1, 1)]],
                    kw=dict(max_new=16, spec_tokens=4)),
    "spec_off": dict(batches=[[_rep_prompt(12), _prompts(3, [9])[0],
                               _rep_prompt(16, 1, 1)]],
                     kw=dict(max_new=16, spec_tokens=4, enable_spec=False)),
    "chunked_prefill": dict(batches=[_prompts(4, [30, 21, 3])],
                            kw=dict(max_new=6, prefill_chunk_tokens=8)),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_port_serve_matches_jax_greedy(case):
    c = SERVE_CASES[case]
    pairs, jm, pm = _serve_both(c["batches"], **c["kw"])
    for j, p in pairs:
        assert p == j
    assert pm.prefix_hit_tokens == jm.prefix_hit_tokens
    assert pm.drafted_tokens == jm.drafted_tokens
    if case == "warm_prefix":
        assert pm.prefix_hit_tokens > 0
    if case == "spec_on":
        assert pm.drafted_tokens > 0
    if case == "chunked_prefill":
        assert pm.prefill_compiles == jm.prefill_compiles


#: deepseek-v2-lite smoke: cold then warm (a page-aligned 16-token shared
#: prefix at page 8), speculation, chunked prefill
MLA_CASES = {
    "cold_then_warm_prefix": dict(
        batches=[_prompts(1, [20, 7]),
                 [_prompts(1, [20])[0] + [1, 2, 3],
                  _prompts(1, [20])[0][:16] + [9, 9],
                  _prompts(2, [6])[0]]],
        kw=dict(max_new=8, page_size=8, max_batch=4)),
    # runs of the tokens this model's greedy decode repeats, so the
    # n-gram drafter proposes and its drafts are accepted
    "spec": dict(batches=[[[241] * 12, _prompts(3, [9])[0], [21] * 16]],
                 kw=dict(max_new=12, spec_tokens=4)),
    "chunked_prefill": dict(batches=[_prompts(4, [30, 21, 3])],
                            kw=dict(max_new=6, prefill_chunk_tokens=8,
                                    page_size=8)),
}


@pytest.mark.parametrize("kernels", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_port_serve_matches_jax_greedy_mla(case, kernels):
    c = MLA_CASES[case]
    pairs, jm, pm = _serve_both(c["batches"], arch=MLA,
                                jax_kw={"use_pallas": kernels},
                                port_kw={"use_kernels": kernels},
                                **c["kw"])
    for j, p in pairs:
        assert p == j
    assert pm.prefix_hit_tokens == jm.prefix_hit_tokens
    assert pm.drafted_tokens == jm.drafted_tokens
    assert pm.accepted_tokens == jm.accepted_tokens
    if case == "cold_then_warm_prefix":
        assert pm.prefix_hit_tokens > 0
    if case == "spec":
        assert pm.accepted_tokens > 0
    if case == "chunked_prefill":
        assert pm.prefill_compiles == jm.prefill_compiles


def test_spec_on_equals_spec_off_in_port():
    sess = _port_session()
    prompts = [_rep_prompt(16), _prompts(5, [10])[0]]
    on = sess.serve(prompts, max_new=32, spec_tokens=4)
    assert sess.engine.metrics.accepted_tokens > 0
    off = sess.serve(prompts, max_new=32, spec_tokens=4, enable_spec=False)
    assert on == off
    assert not sess.engine._pending and sess.engine.pool.pages_held == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_greedy_pipeline_depth_and_kernels_flag_invariant(depth):
    """use_kernels=True on CPU tensors takes the plain versions; output is
    the same at both pipeline depths."""
    sess = _port_session()
    prompts = _prompts(6, [11, 4, 19])
    base = sess.serve(prompts, max_new=6)
    assert sess.serve(prompts, max_new=6, pipeline_depth=depth,
                      use_kernels=True) == base


# ---------------------------------------------------------------------------
# Sampled rows: purity (ported from tests/test_sampling.py)
# ---------------------------------------------------------------------------

def test_threefry_known_answers():
    """Random123's Threefry-2x32 (20 rounds) known-answer vectors, the
    ones JAX's own tests check."""
    def run(key, ctr):
        t = [torch.tensor(x, dtype=torch.int64) for x in key + ctr]
        return [int(w) for w in threefry2x32(t[:2], t[2:])]
    assert run([0] * 2, [0] * 2) == [0x6b200159, 0x99ba4efe]
    assert run([0xffffffff] * 2, [0xffffffff] * 2) == [0x1cb996fc,
                                                       0xbb002be7]
    assert run([0x13198a2e, 0x03707344],
               [0x243f6a88, 0x85a308d3]) == [0xc4923a9c, 0x483df7a0]


def test_sample_tokens_greedy_and_determinism():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    idx = torch.arange(4) + 10
    rows = lambda p: torch.from_numpy(np.stack([pack_params(p)] * 4))
    out = sample_tokens(logits, rows(GREEDY), idx)
    assert (out == logits.argmax(-1)).all()        # temp 0 -> argmax
    # top_k=1 pins the support to the argmax whatever the temperature
    out1 = sample_tokens(logits, rows(SamplingParams(temperature=2.0,
                                                     top_k=1, seed=5)), idx)
    assert (out1 == logits.argmax(-1)).all()
    # pure function of (logits, params, idx): row position is irrelevant
    a = sample_tokens(logits, rows(SAMPLED), idx)
    b = sample_tokens(logits.flip(0), rows(SAMPLED), idx.flip(0))
    assert (a == b.flip(0)).all()
    # ... but the counter index matters (different position, fresh draw)
    flat = torch.zeros((4, 32))
    hot = rows(SamplingParams(temperature=5.0, seed=3))
    assert (sample_tokens(flat, hot, idx)
            != sample_tokens(flat, hot, idx + 17)).any()


def test_sampled_draws_follow_the_distribution():
    """Gumbel-max over threefry noise samples softmax(logits / T): the
    empirical frequencies over many counter indices match the
    probabilities (4 categories, 4000 draws, 3-sigma band)."""
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]]))
    n = 4000
    p = torch.from_numpy(np.stack([pack_params(
        SamplingParams(temperature=1.0, seed=11))] * n))
    toks = sample_tokens(logits.expand(n, 4), p, torch.arange(n))
    freq = torch.bincount(toks.long(), minlength=4).double() / n
    want = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    assert ((freq - want).abs() <= 3 * (want * (1 - want) / n).sqrt()).all()


def test_ngram_drafter_proposes_continuations():
    d = NGramDrafter(ngram=2)
    hist = [1, 2, 3, 1, 2, 3, 1, 2]
    assert d.propose(hist, 3) == (3, 1, 2)
    assert d.propose(hist + [9], 3) == ()
    assert d.propose(hist, 0) == ()


def test_sampled_invariant_to_batch_composition():
    sess = _port_session()
    target = _prompts(7, [9])[0]
    others = _prompts(8, [7, 12, 5])
    alone = sess.serve([target], max_new=5, sampling=SAMPLED,
                       max_batch=2, max_seq_len=64)[0]
    mixed = sess.serve([others[0], target, others[1]], max_new=5,
                       sampling=[None, SAMPLED, None], max_batch=2,
                       max_seq_len=64)
    assert mixed[1] == alone
    both = sess.serve([others[2], target], max_new=5,
                      sampling=[SamplingParams(temperature=1.3, seed=99),
                                SAMPLED], max_batch=2, max_seq_len=64)
    assert both[1] == alone


def test_sampled_pipeline_depth_and_spec_invariant():
    sess = _port_session()
    prompts = [_rep_prompt(12), _prompts(9, [8])[0], _prompts(10, [5])[0]]
    samp = [SamplingParams(temperature=0.7, top_k=1, seed=42), SAMPLED,
            SamplingParams(temperature=1.1, top_p=0.8, seed=21)]
    base = sess.serve(prompts, max_new=12, sampling=samp, pipeline_depth=1,
                      enable_spec=False)
    assert sess.serve(prompts, max_new=12, sampling=samp,
                      pipeline_depth=2, enable_spec=False) == base
    spec = sess.serve(prompts, max_new=12, sampling=samp, pipeline_depth=1)
    assert sess.engine.metrics.drafted_tokens > 0
    assert spec == base
    assert len({tuple(o) for o in base}) > 1


def test_sampled_warm_vs_cold_prefix_cache():
    """A warm prefix cache changes how much prefill runs, never which
    tokens come out; the greedy next-token memo must not serve a sampled
    request's first token."""
    sess = _port_session()
    p = _prompts(11, [12])[0]
    kw = dict(max_new=5, max_batch=2, max_seq_len=64, page_size=4)
    cold = sess.serve([p], sampling=SAMPLED, **kw)[0]
    warm_sess = _port_session()
    greedy = warm_sess.serve([p, p], **kw)           # seeds cache + memo
    warm = warm_sess.serve([p, p], sampling=SAMPLED, **kw)
    assert warm[0] == warm[1] == cold
    assert warm_sess.engine.metrics.prefix_hit_tokens > 0
    assert cold != greedy[0]


def test_sampled_preemption_resume_exact():
    """Page pressure evicts a sampled request mid-run; on resume with a
    longer prompt the counter-keyed draws replay the same continuation."""
    sess = _port_session()
    prompts = _prompts(12, [14, 15])
    kw = dict(max_new=12, max_batch=2, max_seq_len=32, page_size=4)
    calm = sess.serve(prompts, sampling=SAMPLED, **kw)
    tight = sess.serve(prompts, sampling=SAMPLED, num_pages=12,
                       pipeline_depth=2, **kw)
    assert sess.engine.metrics.preemptions >= 1
    assert tight == calm


# ---------------------------------------------------------------------------
# int8 pages and mixtral serve; what is not ported fails loudly, naming
# the ROADMAP item
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(kv_dtype="int8"),
                                   dict(kv_dtype="int8",
                                        enable_prefix_cache=False),
                                   dict(kv_dtype="int8", kv_layout="paged")])
def test_unported_engine_paths_raise(knobs):
    """int8 per-head pages serve on every paged engine path (prefix cache
    on and off, ``kv_layout`` auto and paged): the greedy streams equal
    the JAX int8 engine's on the same weights, on a quantized pool."""
    pairs, jm, pm = _serve_both([_prompts(5, [9, 14, 6])], max_new=6,
                                **knobs)
    for j, p in pairs:
        assert p == j
    assert pm.prefix_hit_tokens == jm.prefix_hit_tokens


def test_unported_families_and_train_raise():
    """The encdec family (whisper) loads with the reference's
    capabilities and refuses to serve, as the reference does
    (``tests/test_torch_encdec_vlm.py``).  The moe, hybrid and ssm
    families and checkpoint / resume train (``tests/test_torch_train_
    families.py``, ``tests/test_torch_checkpoint.py``), and so does
    ``dp_mode="fsdp"`` (no longer unported: on one device it is the
    replicated run; meshes in ``tests/test_torch_mesh_train.py``)."""
    # mixtral (swa + MoE) serves on ring pages with the reference's
    # capabilities
    mx = port_api.load("mixtral-8x22b", smoke=True, device="cpu")
    assert mx.capabilities() == _jax_session(
        "mixtral-8x22b").bundle.capabilities()
    assert mx.bundle.kv_layout.ring
    wh = port_api.load("whisper-tiny", smoke=True, device="cpu")
    assert wh.capabilities() == _jax_session(
        "whisper-tiny").bundle.capabilities() == {"train"}
    with pytest.raises(port_api.CapabilityError, match="doesn't serve"):
        wh.serve([[1, 2, 3]])
    # the recurrent families serve (slotted) and train
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        rec = port_api.load(arch, smoke=True, device="cpu")
        assert rec.capabilities() == {"train", "serve"}
    ds = port_api.load(MLA, smoke=True, device="cpu")
    assert {"paged_serve", "prefix_serve", "spec_serve",
            "train"} <= ds.capabilities()
    sess = port_api.load(ARCH, smoke=True, device="cpu")
    assert {"serve", "paged_serve", "prefix_serve",
            "spec_serve"} <= sess.capabilities()
    assert "train" in sess.capabilities()
    # fsdp placement trains; on one device it is the replicated run
    fsdp = port_api.load(ARCH, smoke=True, device="cpu", dp_mode="fsdp")
    got = fsdp.train(steps=2, seq_len=8, global_batch=2).losses
    assert got == sess.train(steps=2, seq_len=8, global_batch=2).losses


# ---------------------------------------------------------------------------
# The recurrent families through the Session (slotted pool)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_port_serve_matches_jax_greedy_recurrent(arch, kernels):
    """``Session.serve`` of a recurrent family (``kv_layout="auto"``
    resolves to the slotted pool) equals the JAX Session's streams; with
    ``use_kernels`` the port's prefill takes K9 / K10 / K3's plain
    versions."""
    prompts = _prompts(13, [9, 17, 5, 12])
    pairs, jm, pm = _serve_both([prompts], arch=arch,
                                port_kw={"use_kernels": kernels},
                                max_new=10)
    for j, p in pairs:
        assert p == j
    assert pm.prefill_compiles == jm.prefill_compiles == len(prompts)
    assert _port_session(arch).generate(prompts[0], max_new=6) \
        == _jax_session(arch).generate(prompts[0], max_new=6)
