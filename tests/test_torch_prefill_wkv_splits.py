"""K7's split over key tiles and K10's staged, row-split recurrence, on the
CPU.

The bf16 K7 kernel (``csrc/paged_mla_prefill.cu``) gives a block 4 queries
(all heads), walks the keys up to its last live query's causal horizon in
32-key rounds and, when the chunk is long, splits those key tiles over the
blocks of one cluster, which merge in the same launch.  The K10 kernel
(``csrc/wkv6.cu``) splits every (b, h)'s state columns over blocks of 16,
each column's rows over threads of 8 rows, and stages the steps 32 at a
time.  The kernels run only on the card; what decides their work is Python
here: ``mla_prefill_key_tiles`` (a block's key range), ``mla_prefill_splits``
(the count, from shapes and the chunk's host-side bounds only),
``split_range`` and ``merge_partials_ref`` (the merge's plain version).  A
plain emulation of each kernel's order of work — K7's rounds, online
softmax with P as hi + lo bf16, splits and merge; K10's column blocks, row
split, two accumulators a thread and chunked steps — is held against the
JAX package on the same numpy inputs: ``paged_mla_prefill_ref`` and the
Pallas ``paged_mla_prefill_kernel`` in interpret mode (as
``test_torch_mla.py`` runs it) for K7, ``wkv6_ref`` and the Pallas
``wkv6_padded`` in interpret mode (as ``test_torch_rwkv6.py`` runs it) for
K10.  And the port's fp32 ``rwkv_forward`` is held against JAX's over a
128-token sequence, layer by layer.

Tolerances: K7 5e-5 (fp32 inputs; P enters P V as hi + lo bf16, ~2^-17
of itself, and outputs are averages of N(0, 1) latents of magnitude < 4);
K10 1e-4 (the JAX package's own kernel-test bound: the same recurrence,
summed in another order, s0 ~ N(0, 1)); the rwkv6 forward's hidden states
and logits 1e-4 of max(1, |JAX|), the card's K10 bound (over 128 tokens
the difference grows layer by layer on both sides' own sums).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention import ref as jax_ref
from repro.kernels.rwkv6_wkv import ops as jax_wkv_ops
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_wkv_ref
from repro.models import registry as jax_registry
from repro.models import rwkv6 as jr
from repro.models.transformer import lm_head as jax_lm_head
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.paged_attention.kernel import (
    MLA_MAX_SPLITS, MLA_PREFILL_KEYS, MLA_PREFILL_QUERIES,
    mla_prefill_key_tiles, mla_prefill_splits, split_range)
from repro_torch.kernels.paged_attention.ref import merge_partials_ref
from repro_torch.kernels.rwkv6_wkv.kernel import (WKV_CHUNK, WKV_COLUMNS,
                                                  WKV_ROWS)
from repro_torch.models import rwkv6 as pr
from repro_torch.models.common import stack_slice
from repro_torch.models.transformer import embed_lookup
from repro_torch.models.transformer import lm_head as port_lm_head

H100_SMS = 132
QG, KT = MLA_PREFILL_QUERIES, MLA_PREFILL_KEYS

# ---------------------------------------------------------------------------
# K7: the key walk and its split
# ---------------------------------------------------------------------------

#: (S, start, n_valid): deepseek's verify rows and prefill buckets (the
#: card's K7_CASES), long-prefix verifies, larger buckets and a partial
#: last query block
K7_CASES = [(5, 0, 5), (5, 37, 3), (5, 70, 5), (16, 32, 14), (32, 0, 23),
            (64, 0, 46), (5, 100, 5), (5, 480, 5), (64, 64, 64),
            (256, 0, 200), (256, 48, 256), (7, 200, 6)]


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("case", K7_CASES)
def test_k7_splits_cover_exactly_the_kept_key_tiles(case, sms):
    """Every block of 4 queries walks the key tiles of exactly the keys the
    plain version's mask keeps for its live queries (k < start + n_valid
    and k <= start + i): the split ranges of ``split_range`` partition
    them, the keys read, [k0, min(t1 * 32, hi)), stop at the last kept key
    (nothing past the written bound, where the table's tail names the
    trash page), and a block of padding queries reads none."""
    S, start, n_valid = case
    splits = mla_prefill_splits(S, start, n_valid, sms)
    live_blocks = -(-n_valid // QG)
    assert 1 <= splits <= min(MLA_MAX_SPLITS, max(1, sms // live_blocks))
    for q0 in range(0, S, QG):
        tiles = mla_prefill_key_tiles(q0, start, n_valid)
        queries = range(q0, min(q0 + QG, n_valid))
        if not queries:
            assert tiles == 0
            continue
        kept = set().union(*(range(min(start + n_valid, start + i + 1))
                             for i in queries))
        hi = max(kept) + 1
        assert kept == set(range(hi))
        assert (tiles - 1) * KT < hi <= tiles * KT
        read, covered = [], []
        for z in range(splits):
            t0, t1 = split_range(tiles, splits, z)
            covered += range(t0, t1)
            read += range(t0 * KT, min(t1 * KT, hi)) if t1 > t0 else []
        assert covered == list(range(tiles))
        assert read == list(range(hi))


def test_k7_split_counts_at_the_drive_shapes():
    """The hot verify (5, 37, 3) walks 2 key tiles and stays whole (a merge
    costs about what a split saves); the long-prefix verifies split their
    4 and 16 tiles; a cold bucket, whose first blocks have one tile, and
    the chunk shapes past ~1 block per SM stay whole or split little."""
    assert mla_prefill_splits(5, 37, 3, H100_SMS) == 1
    assert mla_prefill_splits(5, 0, 5, H100_SMS) == 1
    assert mla_prefill_splits(5, 70, 5, H100_SMS) == 3
    assert mla_prefill_splits(5, 100, 5, H100_SMS) == 4
    assert mla_prefill_splits(5, 480, 5, H100_SMS) == 8
    assert mla_prefill_splits(64, 0, 46, H100_SMS) == 1
    assert mla_prefill_splits(256, 0, 200, H100_SMS) == 2
    assert mla_prefill_splits(256, 0, 200, 16) == 1


def split_mla_prefill(q_lat, q_rope, ckv, krope, row, start, n_valid, scale,
                      splits):
    """Plain emulation of the bf16 K7 kernel's order of work: per block of
    4 queries, its key tiles (``mla_prefill_key_tiles``) cut by
    ``split_range``; each split's keys in 32-key rounds through an online
    softmax — masked keys exactly 0 while a row's max is NEG_INF, l from
    fp32 P, P V from P as hi + lo bf16 — into (m, l, acc), an empty split
    (NEG_INF, 0, 0); then ``merge_partials_ref``; padding rows 0.  fp32
    [S, H, R | rp] -> [S, H, R]."""
    S, H, R = q_lat.shape
    ps = ckv.shape[1]
    out = torch.zeros(S, H, R)
    for q0 in range(0, S, QG):
        tiles = mla_prefill_key_tiles(q0, start, n_valid)
        if tiles == 0:
            continue
        qs = torch.arange(q0, min(q0 + QG, S))
        hi = start + min(q0 + QG, n_valid)
        parts = []
        for z in range(splits):
            t0, t1 = split_range(tiles, splits, z)
            k1 = min(t1 * KT, hi)
            m = torch.full((len(qs), H), NEG_INF)
            l, acc = torch.zeros(len(qs), H), torch.zeros(len(qs), H, R)
            for kr in range(t0 * KT, k1 if t1 > t0 else t0 * KT, KT):
                pos = torch.arange(kr, min(kr + KT, k1))
                pages, off = row[pos // ps].long(), pos % ps
                c = ckv[pages, off]
                s = (torch.einsum("qhr,tr->qht", q_lat[qs], c)
                     + torch.einsum("qhr,tr->qht", q_rope[qs],
                                    krope[pages, off])) * scale
                live = ((pos[None, :] <= start + qs[:, None])
                        & (qs[:, None] < n_valid))[:, None, :]
                s = torch.where(live, s, torch.full((), NEG_INF))
                m_new = torch.maximum(m, s.amax(dim=-1))
                base = torch.where(m_new == NEG_INF, torch.zeros(()), m_new)
                corr = torch.exp(m - base)
                p = torch.where(live, torch.exp(s - base[..., None]),
                                torch.zeros(()))
                p_hi = p.bfloat16().float()
                p_pv = p_hi + (p - p_hi).bfloat16().float()
                l = l * corr + p.sum(dim=-1)
                acc = (acc * corr[..., None]
                       + torch.einsum("qht,tr->qhr", p_pv, c))
                m = m_new
            parts.append((m.reshape(-1), l.reshape(-1), acc.reshape(-1, R)))
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        merged = merge_partials_ref(m, l, acc).reshape(len(qs), H, R)
        keep = qs < n_valid
        out[qs[keep]] = merged[keep]
    return out


#: (S, start, n_valid, ps): a cold verify, a ragged verify after a
#: prefix, a bucket with a padded tail, a long-prefix verify of 4 key
#: tiles and a partial last query block (S 7) over 5 tiles
K7_NUM_CASES = [(5, 0, 5, 8), (5, 21, 3, 8), (16, 9, 13, 4), (5, 100, 5, 8),
                (7, 131, 6, 16)]


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", K7_NUM_CASES)
def test_k7_split_emulation_matches_jax_kernel(case, splits):
    """At the smoke geometry (H 4, R 32, rp 8: the kernel's small
    instantiation), the emulation at forced split counts (8 splits of 1-5
    tiles leave splits empty) against the JAX oracle and the Pallas kernel
    in interpret mode, the trash page poisoned and named by the table's
    tail."""
    S, start, n_valid, ps = case
    H, R, rp = 4, 32, 8
    rng = np.random.default_rng(start + splits)
    n = -(-(start + n_valid) // ps) + 1
    ckv = rng.normal(size=(n + 3, ps, R)).astype(np.float32)
    kr = rng.normal(size=(n + 3, ps, rp)).astype(np.float32)
    ckv[0], kr[0] = 1e4, -1e4                   # the trash page, poisoned
    table = np.zeros(n, np.int32)
    table[:n - 1] = rng.permutation(n + 2)[:n - 1] + 1
    q_lat = rng.normal(size=(S, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(S, H, rp)).astype(np.float32)
    scale = 24 ** -0.5
    got = split_mla_prefill(*map(torch.from_numpy,
                                 (q_lat, q_rope, ckv, kr, table)),
                            start, n_valid, scale, splits).numpy()
    jargs = (jnp.asarray(q_lat), jnp.asarray(q_rope), jnp.asarray(ckv),
             jnp.asarray(kr), jnp.asarray(table), start, n_valid)
    want = np.asarray(jax_ref.paged_mla_prefill_ref(*jargs, scale=scale))
    pallas = np.asarray(jax_ops.paged_mla_prefill(
        *jargs, scale=scale, use_kernel=True, interpret=True))
    for w in (want, pallas):
        np.testing.assert_allclose(got[:n_valid], w[:n_valid], rtol=0,
                                   atol=5e-5)
    assert (got[n_valid:] == 0).all()           # padding rows come back 0


# ---------------------------------------------------------------------------
# K10: column blocks, row split, chunked steps
# ---------------------------------------------------------------------------

def staged_wkv(r, k, v, w, u, s0):
    """Plain emulation of the K10 kernel's order of work, model layout
    [B, S, H, hd] fp32: per (b, h) the state columns in blocks of 16, each
    column's rows over hd / 8 threads — thread g holds the rows of 16-byte
    groups g and g + hd / 8 — the steps in chunks of 32 with the state
    carried across; a thread's share of out_j in two accumulators (rows
    alternating), the column's threads summed in order.  Asserts the
    threads' rows and the blocks' columns cover the state once."""
    B, S, H, hd = r.shape
    split = hd // WKV_ROWS
    rows = [[4 * (g + split * s) + e for s in range(2) for e in range(4)]
            for g in range(split)]
    assert sorted(sum(rows, [])) == list(range(hd))
    blocks = [range(c0, c0 + WKV_COLUMNS) for c0 in range(0, hd, WKV_COLUMNS)]
    assert sorted(j for b in blocks for j in b) == list(range(hd))
    out = torch.zeros(B, S, H, hd)
    st = s0.clone()                              # [B, H, i, j]
    for t0 in range(0, S, WKV_CHUNK):
        for t in range(t0, min(t0 + WKV_CHUNK, S)):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # [B, H, i, j]
            term = r[:, t, :, :, None] * (st + u[None, :, :, None] * kv)
            total = torch.zeros(B, H, hd)
            for g in range(split):
                acc = [torch.zeros(B, H, hd), torch.zeros(B, H, hd)]
                for n, i in enumerate(rows[g]):
                    acc[n & 1] = acc[n & 1] + term[:, :, i]
                total = total + (acc[0] + acc[1])
            out[:, t] = total
            st = w[:, t, :, :, None] * st + kv
    return out, st


#: (B, S, H, hd): across one and several 32-step chunks, an odd head
#: count, and each head size the kernel takes
K10_CASES = [(1, 31, 2, 16), (1, 33, 2, 64), (2, 71, 3, 32), (1, 100, 1, 64)]


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_staged_emulation_matches_jax_kernel(case):
    """The emulation against the JAX oracle and the Pallas kernel in
    interpret mode, s0 != 0: outputs and the final state."""
    B, S, H, hd = case
    rng = np.random.default_rng(S * hd)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, hd)))).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    out, s_last = staged_wkv(*map(torch.from_numpy, (r, k, v, w, u, s0)))

    def flat(t):
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(B * H, S, hd))
    uf = np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd)
    oref, sref = jax_wkv_ref(flat(r), flat(k), flat(v), flat(w),
                             jnp.asarray(uf),
                             jnp.asarray(s0.reshape(B * H, hd, hd)))
    want = (np.asarray(oref).reshape(B, H, S, hd).transpose(0, 2, 1, 3),
            np.asarray(sref).reshape(B, H, hd, hd))
    pallas = jax_wkv_ops.wkv6(*map(jnp.asarray, (r, k, v, w, u, s0)),
                              interpret=True, block_t=16)
    for wo, ws in (want, pallas):
        np.testing.assert_allclose(out.numpy(), np.asarray(wo), atol=1e-4)
        np.testing.assert_allclose(s_last.numpy(), np.asarray(ws),
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# rwkv6 in fp32 over a longer sequence, layer by layer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rwkv():
    cfg = get_config("rwkv6-1.6b", smoke=True)
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(7))
    np_params = jax.tree.map(np.asarray, params)
    return (cfg, params, port_get_config("rwkv6-1.6b", smoke=True),
            from_jax_params(np_params))


def test_rwkv_forward_fp32_128_tokens_matches_jax_layer_by_layer():
    """The port's fp32 rwkv6 (smoke width) against the JAX package over 128
    tokens, the recurrence through K10's plain version: every layer's
    hidden state, then the logits, within 1e-4 of max(1, |JAX|) (K10's
    card bound).  The two sides sum the same fp32 terms in other orders,
    and their difference grows with depth (3e-6, 2.4e-5, 8.9e-5 after the
    three layers here, against |x| <= 7): the reference amplifies too."""

    def close(got, want, what):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), (what, err)

    cfg, params, pcfg, pp = _rwkv()
    assert cfg.compute_dtype == "float32"
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 128))
    jx = jr.embed_lookup(cfg, params, jnp.asarray(tokens, jnp.int32),
                         jnp.float32)
    px = embed_lookup(pcfg, pp, torch.from_numpy(tokens), torch.float32)
    for i in range(cfg.num_layers):
        jlp = jax.tree.map(lambda a: a[i], params["layers"])
        jx = jr.layer_apply(cfg, jlp, jx)[0]
        px = pr.layer_apply(pcfg, stack_slice(pp["layers"], i), px,
                            use_kernels=True)[0]
        close(px.numpy(), np.asarray(jx), f"layer {i}")
    jl = jax_lm_head(cfg, params, jr.apply_norm(cfg, params["final_norm"],
                                                 jx))
    pl = port_lm_head(pcfg, pp, pr.apply_norm(pcfg, pp["final_norm"], px))
    close(pl.numpy(), np.asarray(jl), "logits")
