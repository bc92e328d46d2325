"""Per-architecture smoke tests and the attention substrate's behaviour, on
the port — the counterparts of ``tests/test_models_smoke.py`` and
``tests/test_attention.py``, with the reference's assertions held on the
port's side (parity with the JAX package lives in the other
``test_torch_*`` files) and the JAX package's parameter counts.

  * every registry arch at its smoke config runs one train step (finite
    loss, nonzero finite gradients) and a prefill plus one decode step
    (logits [B, V], finite; the decode changes the state, which the port
    writes in place);
  * every full config builds and counts what the JAX package counts,
    inside the published windows; mixtral's active parameters < 0.45 x
    its total;
  * chunked attention == naive, windowed == chunked, ring-buffer decode ==
    recomputed prefill attention past the window, MLA absorbed decode ==
    expanded, and a ring cache's slot positions.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jax_registry
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.transparent import _value_and_grad
from repro_torch.models import attention as A
from repro_torch.models import registry
from repro_torch.models.common import init_params, tree_leaves

B, S = 2, 16


def _batch_for(cfg, rng):
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    if cfg.family == "encdec":
        return {"frames": torch.from_numpy(rng.normal(
            size=(B, cfg.encdec.encoder_seq_len, cfg.d_model))).float(),
            "tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        return {"tokens": toks,
                "patches": torch.from_numpy(rng.normal(
                    size=(B, cfg.vlm.num_image_tokens, cfg.d_model))).float(),
                "labels": labels}
    return {"tokens": toks, "labels": labels}


def _setup(arch):
    cfg = get_config(arch, smoke=True)
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    return cfg, bundle, params, _batch_for(cfg, np.random.default_rng(0))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step(arch):
    cfg, bundle, params, batch = _setup(arch)
    loss, grads = _value_and_grad(bundle.loss_fn, params, batch)
    assert loss.shape == ()
    assert torch.isfinite(loss), f"{arch}: non-finite loss"
    gnorm = sum(float(g.abs().sum()) for g in tree_leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0, f"{arch}: bad grads"


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode(arch):
    cfg, bundle, params, batch = _setup(arch)
    with torch.no_grad():
        if cfg.family == "encdec":
            logits, state = bundle.prefill_fn(params, batch["frames"],
                                              batch["tokens"])
        elif cfg.family == "vlm":
            logits, state = bundle.prefill_fn(params, batch["tokens"],
                                              batch["patches"])
        else:
            logits, state = bundle.prefill_fn(params, batch["tokens"])
        assert logits.shape == (B, cfg.vocab_size), (arch, logits.shape)
        assert torch.isfinite(logits).all()
        before = [t.clone() for t in tree_leaves(state)]
        logits2, state2 = bundle.decode_fn(
            params, torch.ones((B, 1), dtype=torch.int64), state)
    assert logits2.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits2).all(), f"{arch}: decode NaN"
    # decoding advances positions/state
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state2))), \
        f"{arch}: state unchanged"


EXPECTED_PARAMS_B = {
    # total params (billions), the reference's windows around the
    # published sizes
    "qwen2.5-14b": (12, 18),
    "mistral-nemo-12b": (10, 14),
    "minitron-8b": (7, 11),
    "stablelm-1.6b": (1.2, 2.2),
    "recurrentgemma-2b": (2.0, 3.5),
    "rwkv6-1.6b": (1.2, 2.4),
    "mixtral-8x22b": (120, 155),
    "whisper-tiny": (0.02, 0.06),
    "pixtral-12b": (10, 14),
    "deepseek-v2-lite-16b": (10, 20),
}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_config_counts_what_jax_counts(arch):
    """Every full config builds (specs only, nothing allocated) and its
    parameter count is the JAX package's, inside the published window."""
    cfg = get_config(arch)
    cfg.validate()
    n = registry.count_params(cfg)
    assert n == jax_registry.count_params(jax_get_config(arch))
    assert n > 1e7, f"{arch}: implausibly small param count {n}"
    lo, hi = EXPECTED_PARAMS_B[arch]
    assert lo <= n / 1e9 <= hi, f"{arch}: {n / 1e9:.2f}B outside [{lo},{hi}]"


def test_moe_active_params_smaller():
    cfg = get_config("mixtral-8x22b")
    total = registry.count_params(cfg)
    active = registry.count_params(cfg, active_only=True)
    assert active < 0.45 * total        # 2 of 8 experts active + attn/embed
    assert active == jax_registry.count_params(
        jax_get_config("mixtral-8x22b"), active_only=True)


# ---------------------------------------------------------------------------
# The attention substrate (tests/test_attention.py)
# ---------------------------------------------------------------------------

def _naive(q, k, v, causal=True, window=0):
    Bq, Sq, H, hd = q.shape
    G = H // k.shape[2]
    kf = torch.repeat_interleave(k, G, dim=2)
    vf = torch.repeat_interleave(v, G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) / np.sqrt(hd)
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    m = torch.ones((Sq, k.shape[1]), dtype=torch.bool)
    if causal:
        m &= kp <= qp
    if window:
        m &= kp > qp - window
    s = torch.where(m, s, torch.tensor(-1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen)


@pytest.mark.parametrize("S_,H,KV,hd,window", [
    (64, 4, 2, 16, 0), (96, 4, 1, 32, 0), (128, 2, 2, 16, 24),
])
def test_attention_core_matches_naive(S_, H, KV, hd, window):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (_randn(gen, 2, S_, n, hd) for n in (H, KV, KV))
    pos = torch.arange(S_)
    out = A.attention_core(q, k, v, pos, pos, causal=True, window=window,
                           q_block=32, kv_block=32)
    torch.testing.assert_close(out, _naive(q, k, v, window=window),
                               atol=2e-5, rtol=0)


def test_windowed_attention_matches_core():
    gen = torch.Generator().manual_seed(1)
    S_, W = 256, 32
    q, k, v = (_randn(gen, 2, S_, n, 16) for n in (4, 2, 2))
    pos = torch.arange(S_)
    out = A.windowed_attention(q, k, v, pos, pos, window=W, q_block=32)
    ref = A.attention_core(q, k, v, pos, pos, causal=True, window=W)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


def test_decode_matches_prefill_recompute():
    """Token-by-token decode through the ring cache equals full-context
    attention at every step (windowed: only within-window keys)."""
    gen = torch.Generator().manual_seed(2)
    H, KV, hd, W, T = 2, 1, 16, 8, 20        # T > window: the ring wraps
    cache = A.init_cache(1, W, KV, hd, torch.float32, "cpu")
    ks, vs = _randn(gen, 1, T, KV, hd), _randn(gen, 1, T, KV, hd)
    qs = _randn(gen, 1, T, H, hd)
    for t in range(T):
        A.cache_update(cache, ks[:, t:t + 1], vs[:, t:t + 1])
        out = A.decode_attend(qs[:, t:t + 1], cache, window=W)
        lo = max(0, t - W + 1)
        ref = _naive(qs[:, t:t + 1], ks[:, lo:t + 1], vs[:, lo:t + 1],
                     causal=False)
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0,
                                   msg=f"step {t}")


def test_mla_absorbed_decode_matches_expanded():
    """The latent-space (absorbed) decode path matches materialised
    per-head K/V attention."""
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    params = init_params(A.mla_specs(cfg), torch.Generator().manual_seed(0))
    T = 6
    xs = _randn(torch.Generator().manual_seed(3), 2, T, cfg.d_model) * 0.1
    cache = A.mla_init_cache(2, T, cfg, torch.float32, "cpu")
    for t in range(T):
        out_abs, cache = A.mla_apply(
            cfg, params, xs[:, t:t + 1],
            torch.full((2, 1), t, dtype=torch.int32), cache=cache)
        out_exp, _ = A.mla_apply(cfg, params, xs[:, :t + 1],
                                 torch.arange(t + 1, dtype=torch.int32))
        torch.testing.assert_close(out_abs[:, 0], out_exp[:, -1], atol=5e-4,
                                   rtol=0, msg=f"step {t}")


def test_cache_positions_track_ring_slots():
    cache = A.init_cache(1, 4, 1, 8, torch.float32, "cpu")
    for _ in range(9):
        A.cache_update(cache, torch.ones((1, 1, 1, 8)),
                       torch.ones((1, 1, 1, 8)))
    # after 9 writes into 4 slots: slots hold positions 8, 5, 6, 7
    assert int(cache["index"]) == 9
    assert cache["pos"].tolist() == [8, 5, 6, 7]
