"""The port's engine over a 2x2 ``data x model`` mesh of 4 gloo processes
against the JAX engine on one device, greedy, on the same weights.

Every rank runs the same engine on the same request stream
(``tests/torch_mesh_worker.py:run_serve``; one spawn for the module runs
every case): tensor-parallel decode over "model" (the whole-head rule:
qwen's 4 query / 2 KV heads are 2 / 1 a rank, recurrentgemma's one KV
head replicates), the vocab-sharded logits gathered before argmax; the
paged pool replicates over "data", the slotted pool puts two of its four
slots on each data rank.  The streams must be token-identical to the JAX
single-device engine's (weights carried across with
``convert.from_jax_params``), and every rank must see the same streams
(the ranks stay in lockstep).  The cases: paged full attention, sliding
window (ring pages) and MLA with the kernels' plain versions and the
"kernel" arms; the slotted pool for qwen, recurrentgemma and rwkv6;
pipeline depth 2 with page-pressure preemption; speculative decoding; a
prefix hit whose two slots sit on different data ranks; int8 pages; and
``Session.serve(mesh="2x2")`` beside the raw engine with that
``mesh_cfg``.  The JAX paged ring engine returns another stream now and
then on this CPU (ROADMAP), so the sliding-window cases hold to the JAX
slotted engine, as ``tests/test_torch_ring.py`` does.
"""
import functools
import threading

import jax
import numpy as np
import pytest

import torch_dp_worker
import torch_mesh_worker
from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import registry as jax_registry
from repro.serving.engine import ServingEngine as JaxEngine

#: the whole 4-process run must finish within this (seconds)
TIMEOUT = 600
QWEN, MIXTRAL, MLA = "qwen2.5-14b", "mixtral-8x22b", "deepseek-v2-lite-16b"


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _rep(n, a=7, b=3):
    return ([a, b] * n)[:n]


_SHARED = _prompts(1, [20])[0]

#: name -> (arch, batches, knobs of both engines, port-only, JAX-only)
CASES = {
    "paged_full_plain": (QWEN, [_prompts(0, [9, 17, 5, 12])], {},
                         {"use_kernels": False}, {"use_pallas": False}),
    "paged_full_kernel": (QWEN, [_prompts(0, [9, 17, 5, 12])], {},
                          {"use_kernels": True}, {"use_pallas": True}),
    "paged_swa_plain": (MIXTRAL, [_prompts(2, [20, 9, 3])],
                        {"page_size": 4}, {"use_kernels": False,
                                           "num_pages": 17},
                        {"kv_layout": "slotted"}),
    "paged_swa_kernel": (MIXTRAL, [_prompts(2, [20, 9, 3])],
                         {"page_size": 4}, {"use_kernels": True,
                                            "num_pages": 17},
                         {"kv_layout": "slotted"}),
    "paged_mla_plain": (MLA, [_prompts(3, [9, 17, 5])], {"page_size": 8},
                        {"use_kernels": False}, {"use_pallas": False}),
    "paged_mla_kernel": (MLA, [_prompts(3, [9, 17, 5])], {"page_size": 8},
                         {"use_kernels": True}, {"use_pallas": True}),
    "slotted_dense": (QWEN, [_prompts(4, [9, 13, 5, 12])],
                      {"kv_layout": "slotted"}, {}, {}),
    "slotted_recurrentgemma": ("recurrentgemma-2b",
                               [_prompts(5, [9, 13, 5, 12])], {}, {}, {}),
    "slotted_rwkv6": ("rwkv6-1.6b", [_prompts(6, [9, 13, 5, 12])], {},
                      {}, {}),
    # a 12-page pool under two 14-15-token prompts growing by 12 tokens:
    # page pressure preempts while the victim's tokens are in flight
    "async_preemption": (QWEN, [_prompts(11, [14, 15])],
                         {"max_batch": 2, "max_seq_len": 32,
                          "max_new_tokens": 12, "num_pages": 12,
                          "page_size": 4, "pipeline_depth": 2}, {}, {}),
    "spec": (QWEN, [[_rep(12), _prompts(7, [9])[0], _rep(16, 1, 1)]],
             {"max_new_tokens": 16, "spec_tokens": 4}, {}, {}),
    # two slots (0 and 1: one a data rank in the JAX engine's layout) map
    # the same cached prefix pages
    "prefix_across_data_ranks": (
        QWEN, [[_SHARED, _prompts(8, [7])[0]],
               [_SHARED + [1, 2, 3], _SHARED[:16] + [9, 9]]],
        {"max_batch": 2, "page_size": 4}, {}, {}),
    "int8_pages": (QWEN, [_prompts(9, [9, 14, 5, 12])] * 2,
                   {"kv_dtype": "int8", "page_size": 4}, {}, {}),
}
BASE = dict(max_batch=4, max_seq_len=48, max_new_tokens=8, decode_steps=2)


def _knobs(case):
    _, _, both, port, jax_only = CASES[case]
    return {**BASE, **both, **port}, {**BASE, **both, **jax_only}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = get_config(arch, smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(3))
    return cfg, params, jax.tree.map(np.asarray, params)


def _jax_streams(case):
    arch, batches, *_ = CASES[case]
    cfg, params, _ = _weights(arch)
    knobs = _knobs(case)[1]
    eng = JaxEngine(cfg, JaxServeConfig(**knobs), params=params)
    streams = [eng.generate(b, knobs["max_new_tokens"]) for b in batches]
    return streams, eng.metrics


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(the ranks' results, the JAX references): the 4 processes serve
    while this process runs the JAX engines."""
    cases = {}
    for name, (arch, batches, *_) in CASES.items():
        cases[name] = (arch, _weights(arch)[2], batches, _knobs(name)[0])
    session_case = (QWEN, _weights(QWEN)[2], _prompts(10, [9, 14, 5]),
                    dict(BASE, max_new_tokens=6))
    out = []
    ranks = threading.Thread(target=lambda: out.append(
        torch_dp_worker.spawn_world(
            torch_mesh_worker.run_serve, 4,
            tmp_path_factory.mktemp("pg") / "pg", (cases, session_case),
            TIMEOUT)))
    ranks.start()
    try:
        want = {case: _jax_streams(case) for case in CASES}
    finally:
        ranks.join(timeout=TIMEOUT + 60)
    assert not ranks.is_alive() and out, "mesh workers did not finish"
    result = out[0]
    if isinstance(result, tuple):
        pytest.fail("mesh workers failed: " + result[1])
    assert result["agree"], "the ranks' streams differ"
    return result["results"], want


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_2x2_streams_equal_the_jax_single_device_engine(mesh_run, case):
    got, counts = mesh_run[0][case]
    want, jm = mesh_run[1][case]
    assert got == want
    if CASES[case][0] in (QWEN, MLA) and "kv_layout" not in CASES[case][2]:
        assert counts["prefix_hit_tokens"] == jm.prefix_hit_tokens
        assert counts["drafted_tokens"] == jm.drafted_tokens
    if case == "async_preemption":
        assert counts["preemptions"] >= 1
    if case == "spec":
        assert counts["accepted_tokens"] > 0
    if case in ("prefix_across_data_ranks", "int8_pages"):
        assert counts["prefix_hit_tokens"] > 0
    if case.startswith("slotted"):
        # four slots over two data ranks: two a rank (rank 0's run)
        assert counts["local_slots"] == (0, 2)


def test_session_serve_on_a_mesh_equals_the_raw_engine(mesh_run):
    got, raw = mesh_run[0]["session"]
    assert got == raw and all(len(s) == 6 for s in got)
