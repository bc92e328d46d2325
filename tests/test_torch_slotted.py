"""The port's slotted pool and whole-prompt-prefill engine path against the
JAX package, on the CPU.

Weights come from the JAX ``bundle.init_params`` and are carried across
with ``from_jax_params``; prompts are made with numpy from a seed.

  * ``SlotKVCachePool``: alloc / insert / read / evict / blanking and the
    byte telemetry equal the JAX pool's, for a dense, a hybrid and an ssm
    state tree;
  * the batched decode of slots at different lengths (one past the
    recurrentgemma smoke window of 8, so its ring wraps) equals each
    request decoded alone, and the JAX decode;
  * greedy engine streams of recurrentgemma and rwkv6 (slotted by
    ``kv_layout="auto"``) equal the JAX engine's with the kernels off and
    on (on: K3 / K9 / K10's plain versions here; the JAX slotted path
    takes no kernel), prefilled at exact length; preemption resumes to the
    same tokens;
  * qwen2.5 on ``kv_layout="slotted"`` equals the JAX slotted engine and
    the port's paged engine (and ``enable_prefix_cache=False``), with the
    JAX engine's prefill shape count;
  * the ``kv_layout="paged"`` rejection and int8 on the slotted pool raise
    the JAX package's errors;
  * sampled rows on the slotted pool: a request's tokens are a pure
    function of (prompt, SamplingParams) whatever the batch, pipeline
    depth or preemption.

Tolerances: a slot's logits in the batched decode against the same
request decoded alone 1e-5 (the same math at another batch size), against
JAX 1e-4, its state after 6 steps 1e-4 (fp32 smoke configs, |state| up to
~4); pool copies exact; token streams identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JaxServeConfig
from repro.configs import get_config
from repro.models import registry as jax_registry
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SlotKVCachePool as JaxSlotPool
from repro_torch.configs import ServeConfig
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import registry as port_registry
from repro_torch.models.common import tree_leaves
from repro_torch.serving import SamplingParams
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import SlotKVCachePool

RG, RWKV, QWEN = "recurrentgemma-2b", "rwkv6-1.6b", "qwen2.5-14b"
RECURRENT = [RG, RWKV]
SAMPLED = SamplingParams(temperature=0.8, top_k=8, top_p=0.9, seed=13)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_config(arch, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(7))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, port_get_config(arch, smoke=True), np_params


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _engines(arch, **knobs):
    """A JAX and a port engine on the same weights and ServeConfig knobs
    (``use_kernels`` goes to the port's only)."""
    cfg, params, pcfg, np_params = _setup(arch)
    port_knobs = dict(knobs)
    knobs.pop("use_kernels", None)
    je = JaxEngine(cfg, JaxServeConfig(**knobs), params=params)
    pe = ServingEngine(pcfg, ServeConfig(**port_knobs),
                       params=from_jax_params(np_params), device="cpu")
    return je, pe


def _assert_tree_equal(port_tree, jax_tree):
    jl = jax.tree.leaves(jax_tree)
    tl = tree_leaves(port_tree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [QWEN, RG, RWKV])
def test_slot_pool_semantics_match_jax(arch):
    cfg, params, pcfg, np_params = _setup(arch)
    jb, pb = jax_registry.build(cfg), port_registry.build(pcfg)
    cap = 16
    jpool = JaxSlotPool(3, lambda: jb.init_decode_state(1, cap))
    ppool = SlotKVCachePool(3, lambda: pb.init_decode_state(1, cap))
    assert ppool.kv_bytes_held() == jpool.kv_bytes_held() \
        == ppool.kv_bytes_slotted() > 0
    for rid in (0, 1, 2):
        assert ppool.alloc(rid) == jpool.alloc(rid)
    assert ppool.alloc(3) is None and jpool.alloc(3) is None
    assert ppool.evict(1) == jpool.evict(1) == 1
    assert ppool.free_slots == jpool.free_slots == 1
    assert ppool.active_slots == jpool.active_slots == [0, 2]
    # the same prefilled state in both pools, so every pool operation is
    # a copy and the trees must agree exactly
    prompt = np.arange(1, 12, dtype=np.int32)[None]
    _, jstate = jb.serve_prefill_fn(params, jnp.asarray(prompt),
                                    cache_len=cap)
    pstate = from_jax_params(jax.tree.map(np.asarray, jstate))
    assert ppool.insert(7, pstate) == jpool.insert(7, jstate) == 1
    jpool.insert_at(0, jstate)
    ppool.insert_at(0, pstate)
    _assert_tree_equal(ppool.read(1), jpool.read(1))
    _assert_tree_equal(ppool.state, jpool.state)
    # eviction blanks the slot: no stale state for the next tenant
    ppool.evict(1)
    jpool.evict(1)
    _assert_tree_equal(ppool.read(1), jb.init_decode_state(1, cap))
    _assert_tree_equal(ppool.state, jpool.state)


@pytest.mark.parametrize("arch", [RG, RWKV, QWEN])
def test_batched_slot_decode_at_different_lengths(arch):
    """Three slots — prompts of 3 and 11 tokens and a blank one — decode 6
    steps as one batch through ``pool.batched()`` (the recurrentgemma ring
    of 8 wraps for the 11-token slot); each occupied slot's logits equal
    its request decoded alone and the JAX decode."""
    cfg, params, pcfg, np_params = _setup(arch)
    jb, pb = jax_registry.build(cfg), port_registry.build(pcfg)
    pp = from_jax_params(np_params)
    cap = 24
    pool = SlotKVCachePool(3, lambda: pb.init_decode_state(1, cap))
    prompts = _prompts(5, [3, 11])
    alone, jalone, toks = [], [], []
    for slot, p in zip((0, 2), prompts):
        x = np.asarray(p, np.int32)[None]
        logits, st = pb.serve_prefill_fn(pp, torch.from_numpy(x),
                                         cache_len=cap)
        pool.insert_at(slot, st)
        _, st1 = pb.serve_prefill_fn(pp, torch.from_numpy(x), cache_len=cap)
        _, jst = jb.serve_prefill_fn(params, jnp.asarray(x), cache_len=cap)
        alone.append(st1)
        jalone.append(jst)
        toks.append(int(torch.argmax(logits[0])))
    jdecode = jax.jit(jb.decode_fn)
    batch = torch.tensor([toks[0], 0, toks[1]])
    for _ in range(6):
        logits, _ = pb.decode_fn(pp, batch[:, None], pool.batched())
        nxt = []
        for i, slot in enumerate((0, 2)):
            one, alone[i] = pb.decode_fn(pp, batch[slot:slot + 1, None],
                                         alone[i])
            jone, jalone[i] = jdecode(
                params, jnp.asarray([[int(batch[slot])]], jnp.int32),
                jalone[i])
            np.testing.assert_allclose(logits[slot].numpy(), one[0].numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(logits[slot].numpy(),
                                       np.asarray(jone[0]), atol=1e-4)
            nxt.append(int(torch.argmax(one[0])))
        batch = torch.tensor([nxt[0], 0, nxt[1]])
    for i, slot in enumerate((0, 2)):
        for got, want in zip(tree_leaves(pool.read(slot)),
                             tree_leaves(alone[i])):
            np.testing.assert_allclose(got.float().numpy(),
                                       want.float().numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# The engine: recurrent families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engine_streams_match_jax(arch, kernels):
    """The slotted greedy streams equal the JAX engine's (which also
    equal its sequential decode, ``test_serving.py:363``); every prompt
    prefills at its exact length (one prefill shape per distinct
    length)."""
    knobs = dict(max_batch=2, max_seq_len=24, max_new_tokens=8,
                 decode_steps=3, use_kernels=kernels)
    je, pe = _engines(arch, **knobs)
    assert not pe.paged and isinstance(pe.pool, SlotKVCachePool)
    prompts = _prompts(1, [6, 9, 5, 9, 12])
    want = je.generate(prompts, 8)
    assert pe.generate(prompts, 8) == want
    assert pe.prefill_compiles == je.prefill_compiles == 4
    assert pe.metrics.summary()["completed"] == len(prompts)
    assert not pe.busy and pe.pool.free_slots == 2


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_preemption_resumes_identically(arch):
    """A high-priority arrival preempts the lone slot's request mid-decode;
    the victim resumes with its emitted tokens folded into the prompt and
    both streams equal the JAX engine's."""
    knobs = dict(max_batch=1, max_seq_len=40, max_new_tokens=8,
                 policy="priority", decode_steps=1, max_prefills_per_step=1)
    outs = []
    for eng in _engines(arch, **knobs):
        low, high = _prompts(3, [6, 5])
        r_low = eng.submit(low, max_new_tokens=8, priority=0)
        eng.step()
        eng.step()
        r_high = eng.submit(high, max_new_tokens=3, priority=5)
        res = eng.run()
        assert eng.metrics.preemptions >= 1
        assert eng.requests[r_low].preempted >= 1
        outs.append((res[r_low], res[r_high]))
    assert outs[1] == outs[0]


def test_paged_layout_rejected_for_recurrent():
    """``kv_layout="paged"`` raises the JAX engine's error; "auto" resolves
    to the slotted pool; int8 on the slotted pool raises the JAX errors."""
    cfg, _, pcfg, _ = _setup(RWKV)
    scfg = dict(max_batch=1, max_seq_len=16)
    msgs = []
    for Engine, Cfg, c, kw in ((JaxEngine, JaxServeConfig, cfg, {}),
                               (ServingEngine, ServeConfig, pcfg,
                                {"device": "cpu"})):
        with pytest.raises(ValueError, match="no paged decode") as e:
            Engine(c, Cfg(**scfg, kv_layout="paged"), **kw)
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="requires a paged KV layout") \
                as e:
            Engine(c, Cfg(**scfg, kv_dtype="int8"), **kw)
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="requires a paged layout") as e:
            Cfg(**scfg, kv_layout="slotted", kv_dtype="int8")
        msgs.append(str(e.value))
    assert msgs[3:] == msgs[:3]
    assert not ServingEngine(pcfg, ServeConfig(**scfg), device="cpu").paged


# ---------------------------------------------------------------------------
# The engine: qwen on the slotted pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_qwen_slotted_matches_jax_and_paged(kernels):
    """``kv_layout="slotted"`` (bucketed whole-prompt prefill, K3's plain
    version with the kernels on) equals the JAX slotted engine and the
    port's paged engine; the slotted pool pins its ceiling while pages
    track live tokens; ``enable_prefix_cache=False`` keeps the paged pool
    and the same tokens."""
    base = dict(max_batch=2, max_seq_len=40, max_new_tokens=5,
                max_prefills_per_step=2, decode_steps=2, page_size=8,
                use_kernels=kernels)
    prompts = _prompts(7, [7, 12, 5, 9])
    je, ps = _engines(QWEN, kv_layout="slotted", **base)
    assert not je.paged and not ps.paged
    want = je.generate(prompts, 5)
    assert ps.generate(prompts, 5) == want
    assert ps.prefill_compiles == je.prefill_compiles
    _, pp = _engines(QWEN, kv_layout="paged", **base)
    assert pp.paged and pp.generate(prompts, 5) == want
    _, pn = _engines(QWEN, enable_prefix_cache=False, **base)
    assert pn.paged and not pn.pool.enable_prefix_cache
    assert pn.generate(prompts, 5) == want
    assert pn.metrics.prefix_hit_tokens == 0
    sp, ss = pp.metrics.summary(), ps.metrics.summary()
    assert 0 < sp["kv_bytes_peak"] < sp["kv_bytes_slotted"]
    assert ss["kv_bytes_peak"] == ss["kv_bytes_slotted"]


# ---------------------------------------------------------------------------
# Sampled rows on the slotted pool: purity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [RWKV, QWEN])
def test_slotted_sampled_purity(arch):
    """A sampled request's tokens do not depend on its batch neighbours,
    the pipeline depth or a preemption (counter-keyed draws at absolute
    indices; the slotted pool carries the index as a host mirror)."""
    cfg, _, pcfg, np_params = _setup(arch)

    def engine(**kw):
        return ServingEngine(pcfg, ServeConfig(
            max_batch=2, max_seq_len=48, max_new_tokens=10, decode_steps=3,
            kv_layout="slotted", **kw),
            params=from_jax_params(np_params), device="cpu")

    target = _prompts(7, [9])[0]
    others = _prompts(8, [7, 12, 5])
    alone = engine().generate([target], 10, sampling=SAMPLED)[0]
    mixed = engine().generate([others[0], target, others[1]], 10,
                              sampling=[None, SAMPLED, None])
    assert mixed[1] == alone
    sync = engine(pipeline_depth=1).generate(
        [others[2], target], 10,
        sampling=[SamplingParams(temperature=1.3, seed=99), SAMPLED])
    assert sync[1] == alone
    eng = engine(policy="priority", max_prefills_per_step=1)
    r = eng.submit(target, max_new_tokens=10, sampling=SAMPLED)
    eng.step()
    eng.step()
    for p in others[:2]:
        eng.submit(p, max_new_tokens=3, priority=5)
    res = eng.run()
    assert eng.metrics.preemptions >= 1
    assert res[r] == alone
    greedy = engine().generate([target], 10)[0]
    assert greedy != alone
