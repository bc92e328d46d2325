"""The engine's decode graphs on the card: graph and eager arms alike.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU; on the
card run

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda_graphs.py

This file imports torch and the port only (no jax).  The configs are the
smoke presets in bf16 at head_dim 64 (a head dim the kernels take; the
smoke presets' 16 is not), deepseek's smoke MLA geometry as it is (one
of K6 / K7's).  Both arms run the same decode body with the same
kernels, so greedy and sampled streams must be equal token for token, not
within a tolerance.
"""
import pytest
import torch

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.kernels.paged_attention import kernel as pk
from repro_torch.serving import SamplingParams
from repro_torch.serving.engine import ServingEngine

SAMPLED = SamplingParams(temperature=0.8, top_k=8, top_p=0.9, seed=13)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [1, 4, 1, 4, 2, 1,
                                                            3, 5, 6, 2, 3]]
#: arch -> (load overrides, serve overrides)
ARCHS = {"qwen2.5-14b": ({"head_dim": 64}, {}),
         "qwen2.5-14b-slotted": ({"head_dim": 64}, {"kv_layout": "slotted"}),
         "deepseek-v2-lite-16b": ({}, {}),
         "mixtral-8x22b": ({"head_dim": 64}, {"page_size": 4,
                                              "num_pages": 64})}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA graphs of the "
                    "port's kernels; run on the card with `pytest -m cuda`)")
    return torch.device("cuda")


def _session(name):
    load_kw, serve_kw = ARCHS[name]
    arch = name.replace("-slotted", "")
    sess = api.load(arch, smoke=True, device=_cuda(), seed=0,
                    compute_dtype="bfloat16", **load_kw)
    return sess, serve_kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ARCHS))
def test_cuda_graph_streams_equal_eager_streams(name):
    sess, kw = _session(name)
    eager = sess.serve(PROMPTS, max_new=12, decode_graphs=False, **kw)
    assert sess.engine.decode_graphs is False
    graphed = sess.serve(PROMPTS, max_new=12, **kw)
    eng = sess.engine
    assert eng.decode_graphs is True and len(eng._graphs) == 1
    assert eng._graphs.replays == eng.decode_cycles > 0
    assert graphed == eager


def _mixed_run(graphs, sampled_late):
    """Three greedy requests decode for a few cycles; then (``sampled_late``)
    a sampled one is admitted beside them."""
    cfg = get_config("qwen2.5-14b", smoke=True).replace(
        head_dim=64, compute_dtype="bfloat16")
    eng = ServingEngine(cfg, ServeConfig(max_batch=4, max_seq_len=64,
                                         decode_graphs=graphs),
                        seed=0, device=_cuda())
    rids = [eng.submit(p, 16) for p in PROMPTS]
    for _ in range(3):
        eng.step()
    if sampled_late:
        rids.append(eng.submit([5, 3, 5, 8, 9, 7], 16, sampling=SAMPLED))
    out = eng.run()
    return eng, [out[r] for r in rids]


@pytest.mark.cuda
def test_cuda_sampled_graph_captured_beside_live_greedy_slots():
    """The sampled graph is first needed (warmed up and captured) while
    greedy slots are live: their streams stay what they are without the
    sampled request, and every stream equals the eager arm's."""
    eng, mixed = _mixed_run(True, True)
    assert len(eng._graphs) == 2              # greedy, then sampled
    _, alone = _mixed_run(True, False)
    _, eager = _mixed_run(False, True)
    assert mixed[:3] == alone
    assert mixed == eager


def _reset(*wrappers):
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "launches_by"):
            w.launches_by = {}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b"])
def test_cuda_replayed_launches_are_counted(arch):
    """The decode kernel's count is its launches on the card: layers x the
    decode steps the device ran (eager warm-ups, and each graph's captured
    launches once per replay).  max_seq_len 512 splits K1's pages, so its
    launches use the split scratch the graph holds."""
    sess, kw = _session(arch)
    decode = pk.paged_mla_kernel if arch.startswith("deepseek") \
        else pk.paged_attention_kernel
    _reset(decode)
    sess.serve(PROMPTS, max_new=24, max_seq_len=512, **kw)
    eng = sess.engine
    L, steps = sess.model.num_layers, eng.cfg.decode_steps
    (graph,) = eng._graphs._graphs.values()
    per_replay = {k: n for k, n in graph.launches.items() if k[0] is decode}
    assert sum(per_replay.values()) == L * steps
    assert decode.launches == L * eng.decode_steps_run
    assert decode.launches == L * steps * (eng._graphs.warmups
                                           + eng._graphs.replays)
    if decode is pk.paged_attention_kernel:
        assert graph.held                    # the split scratch


@pytest.mark.cuda
def test_cuda_failed_capture_raises_and_does_not_fall_back():
    """A decode body that reads a device value back cannot be captured: the
    capture raises with its cause, and nothing decodes eagerly instead."""
    cfg = get_config("qwen2.5-14b", smoke=True).replace(
        head_dim=64, compute_dtype="bfloat16")
    eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_seq_len=32),
                        seed=0, device=_cuda())
    body = eng._decode_loop

    def syncing(toks0, packed, samp=None):
        float(toks0.sum())                    # a host read: no capture
        return body(toks0, packed, samp)

    eng._decode_loop = syncing
    eng.submit([3, 1, 4, 1, 5], 8)
    with pytest.raises(RuntimeError, match="capturing the decode graph"):
        eng.run()
    assert eng.decode_cycles == 0 and len(eng._graphs) == 0
    torch.cuda.synchronize()
