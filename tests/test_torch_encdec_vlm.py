"""The encdec (whisper) and vlm (pixtral) families on the port, against the
JAX package on the same numbers (CPU).

Smoke configs in fp32; the JAX ``init_params`` are carried across with
``from_jax_params``.  Held, with the kernels off and on
(``use_kernels``: attention through K3's plain versions here — the flash
autograd Function's ``_fwd`` / ``_bwd`` and ``attention_ref`` for the
cross-attention), against the reference bundle (``attention_core``):

  * ``loss_fn``: the loss within rel 1e-5, every gradient leaf within
    1e-4 of max(its largest |grad|, 1e-3) — the encoder's key bias gets
    a gradient of rounding noise only (softmax is invariant to it);
  * ``prefill_fn``: last logits and every cache leaf within 1e-5;
  * ``decode_fn`` greedy for 3 x S steps: the self-attention ring caches
    hold exactly S slots, so the steps evict from position 0 on and wrap
    the ring twice; tokens identical, logits within 1e-5;
  * training through ``TransparentTrainer.from_bundle`` on a batch that
    carries frames / patches: step 1's loss is the JAX loss, and 3 adam
    steps of that batch lower it;
  * ``count_params`` at full config (37,051,776 and 12,274,001,920) and
    the reference's capabilities and errors (``tests/test_api.py:74-96``).

The flash autograd Function bidirectional (``causal=False``) over a padded
length, as whisper's encoder trains: values and gradients against
autograd through the plain ``attention_core``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import get_config
from repro.models import registry as jax_registry
from repro_torch import api as port_api
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig, RunConfig,
                                      ServeConfig, ShapeConfig)
from repro_torch.convert import from_jax_params
from repro_torch.core.transparent import TransparentTrainer, _value_and_grad
from repro_torch.models import attention as port_attn
from repro_torch.models import registry as port_registry
from repro_torch.models.common import tree_leaves
from repro_torch.models.flash_vjp import flash_attention_vjp
from repro_torch.serving.engine import ServingEngine

ARCHS = ("whisper-tiny", "pixtral-12b")
B, S = 2, 12
LOSS_RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX bundle, JAX params, port bundle, batch as numpy)."""
    jcfg = get_config(arch, smoke=True)
    jb = jax_registry.build(jcfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    pb = port_registry.build(port_get_config(arch, smoke=True))
    return jb, jp, pb, _batch(jcfg, seed=1)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    jb, jp, _, batch = _setup(arch)
    return jax.jit(jax.value_and_grad(jb.loss_fn))(
        jp, jax.tree.map(jnp.asarray, batch))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        shape = (B, cfg.encdec.encoder_seq_len, cfg.d_model)
        out["frames"] = rng.normal(size=shape).astype(np.float32)
    else:
        shape = (B, cfg.vlm.num_image_tokens, cfg.d_model)
        out["patches"] = rng.normal(size=shape).astype(np.float32)
    return out


def _port_params(jp):
    return from_jax_params(jax.tree.map(np.asarray, jp))


def _prefill_args(arch, batch, lib):
    """The family's prefill inputs in its order: whisper (frames, tokens),
    pixtral (tokens, patches)."""
    names = ("frames", "tokens") if arch == "whisper-tiny" \
        else ("tokens", "patches")
    return [lib(batch[n]) for n in names]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, use_kernels):
    _, jp, pb, batch = _setup(arch)
    jl, jg = _jax_loss_and_grads(arch)
    pl, pg = _value_and_grad(
        functools.partial(pb.loss_fn, use_kernels=use_kernels),
        _port_params(jp), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(pl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    jleaves, pleaves = jax.tree.leaves(jg), tree_leaves(pg)
    assert len(jleaves) == len(pleaves)
    for j, p in zip(jleaves, pleaves):
        j = np.asarray(j)
        assert j.shape == tuple(p.shape)
        scale = max(float(np.abs(j).max()), 1e-3)
        assert float(np.abs(p.numpy() - j).max()) <= GRAD_RTOL * scale


@functools.lru_cache(maxsize=None)
def _jax_stream(arch):
    """The JAX prefill (last logits, state leaves, ring length) and 3 x
    ring greedy decode steps (logits, tokens) on the setup batch."""
    jb, jp, _, batch = _setup(arch)
    logits, state = jax.jit(jb.prefill_fn)(
        jp, *_prefill_args(arch, batch, jnp.asarray))
    first = (np.asarray(logits),
             [np.asarray(x) for x in jax.tree.leaves(state)])
    ring = (state["self"] if arch == "whisper-tiny" else state)["k"].shape[2]
    dec = jax.jit(jb.decode_fn)
    steps = []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(3 * ring):
        logits, state = dec(jp, tok, state)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        steps.append((np.asarray(logits), np.asarray(tok)))
    return first, ring, steps


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_past_the_ring_match_jax(arch, use_kernels):
    _, jp, pb, batch = _setup(arch)
    (jlog, jleaves), ring, steps = _jax_stream(arch)
    pp = _port_params(jp)
    with torch.no_grad():
        plog, pst = pb.prefill_fn(pp, *_prefill_args(arch, batch,
                                                     torch.from_numpy),
                                  use_kernels=use_kernels)
    np.testing.assert_allclose(plog.numpy(), jlog, atol=ATOL)
    pleaves = tree_leaves(pst)
    assert len(jleaves) == len(pleaves)
    for j, p in zip(jleaves, pleaves):
        np.testing.assert_allclose(p.numpy(), j, atol=ATOL)
    # the ring holds exactly the prefill's S slots (n_img + S_text for
    # pixtral): 3 x S steps evict position 0 first and wrap it twice
    assert ring == S + (0 if arch == "whisper-tiny"
                        else get_config(arch, True).vlm.num_image_tokens)
    kw = {"use_kernels": use_kernels} if arch == "whisper-tiny" else {}
    tok = torch.argmax(plog, -1)[:, None]
    for step, (jlog, jtok) in enumerate(steps):
        with torch.no_grad():
            plog, pst = pb.decode_fn(pp, tok, pst, **kw)
        np.testing.assert_allclose(plog.numpy(), jlog, atol=ATOL,
                                   err_msg=f"step {step}")
        tok = torch.argmax(plog, -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), jtok,
                                      err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_trains_through_transparent_trainer(arch):
    """The families train as the reference's smoke tests drive them: a
    batch dict carrying frames / patches (``Session.train``'s synthetic
    data carries tokens only; see ``test_capabilities_and_errors``).
    Three adam steps of the setup batch: step 1's loss is the JAX loss on
    it (rel 1e-5), and the loss falls."""
    _, jp, pb, batch = _setup(arch)
    run = RunConfig(model=pb.cfg, shape=ShapeConfig("t", "train", S, B),
                    mesh=MeshConfig(shape=(1, 1),
                                    axis_names=("data", "model")),
                    optimizer=OptimizerConfig(name="adam", lr=1e-3))
    tr = TransparentTrainer.from_bundle(run, pb, device="cpu")
    state = tr.init(params=_port_params(jp))
    got = []
    for _ in range(3):
        state, m = tr.step(state, batch)
        got.append(float(m["loss"]))
    jl = float(_jax_loss_and_grads(arch)[0])
    assert abs(got[0] - jl) <= LOSS_RTOL * abs(jl)
    assert got[2] < got[1] < got[0]


def test_full_config_param_counts():
    for arch, n in (("whisper-tiny", 37_051_776),
                    ("pixtral-12b", 12_274_001_920)):
        assert port_registry.count_params(port_get_config(arch)) == n \
            == jax_registry.count_params(get_config(arch))


@pytest.mark.parametrize("arch,modality", [("whisper-tiny", "frames"),
                                           ("pixtral-12b", "patches")])
def test_capabilities_and_errors(arch, modality):
    """The counterparts of ``tests/test_api.py:74-96``: loading is fine,
    the capabilities are the reference's, serving refuses at load, at use
    and in the engine; ``Session.train`` fails as the reference's does,
    its synthetic data carrying no frames / patches."""
    with pytest.raises(port_api.CapabilityError, match="doesn't serve"):
        port_api.load(arch, smoke=True, device="cpu", require=("serve",))
    s = port_api.load(arch, smoke=True, device="cpu")
    assert s.capabilities() == jax_api.load(arch, smoke=True).capabilities() \
        == {"train"}
    with pytest.raises(port_api.CapabilityError, match="doesn't serve"):
        s.generate([1, 2, 3])
    with pytest.raises(port_api.CapabilityError, match="doesn't serve"):
        s.serve([[1, 2, 3]])
    with pytest.raises(ValueError, match="no serving"):
        ServingEngine(s.model, ServeConfig(max_batch=1, max_seq_len=16),
                      device="cpu")
    with pytest.raises(KeyError, match=modality):
        s.train(steps=1, seq_len=8, global_batch=2)


@pytest.mark.parametrize("S_,bq,bk", [(21, 8, 16), (40, 16, 8)])
def test_bidirectional_flash_function_over_padding(S_, bq, bk):
    """``flash_attention_vjp(causal=False)`` pads S to its tiles (21 -> 32,
    40 -> 48) and masks the padding keys: output and dq / dk / dv equal
    autograd through ``attention_core`` (no mask) within 1e-5."""
    gen = torch.Generator().manual_seed(5)
    Bq, H, KV, hd = 2, 4, 2, 16
    q, k, v = (torch.randn((Bq, S_, n, hd), generator=gen)
               for n in (H, KV, KV))
    do = torch.randn((Bq, S_, H, hd), generator=gen)
    pos = torch.arange(S_, dtype=torch.int32)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_vjp(*xs, causal=False, q_block=bq, kv_block=bk)
    got = torch.autograd.grad(out, xs, do)
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = port_attn.attention_core(*ys, pos, pos, causal=False)
    want = torch.autograd.grad(ref, ys, do)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_whisper_cross_attention_route(monkeypatch):
    """With ``use_kernels`` whisper's cross-attention goes to K3's entry
    point (``flash_ops.flash_attention(use_kernel=True)``) once a layer in
    prefill and in each decode step, and never in the loss, which trains
    it through plain ``attention_core`` (``cross_kernel=False``) whatever
    the autograd state."""
    from repro_torch.models import whisper as port_whisper
    calls = []
    real = port_whisper.flash_ops.flash_attention

    def counted(*a, **kw):
        calls.append(kw["use_kernel"])
        return real(*a, **kw)

    monkeypatch.setattr(port_whisper.flash_ops, "flash_attention", counted)
    _, jp, pb, batch = _setup("whisper-tiny")
    pp = _port_params(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    L = pb.cfg.num_layers
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            pb.loss_fn(pp, tb, use_kernels=True)
    assert calls == []
    with torch.no_grad():
        plog, st = pb.prefill_fn(pp, tb["frames"], tb["tokens"],
                                 use_kernels=True)
        assert calls == [True] * L
        pb.decode_fn(pp, torch.argmax(plog, -1)[:, None], st,
                     use_kernels=True)
    assert calls == [True] * (2 * L)
