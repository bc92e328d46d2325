"""The decode kernel's split over pages (K1 / K4, with their int8 K8
branches) and the merge of the splits' partials, on the CPU.

The CUDA decode kernel (``csrc/paged_attention.cu``) splits every slot's
live pages over ``blockIdx.z`` and merges the splits' fp32 partials in the
same launch.  The kernel runs only on the card; what decides its work is
Python here: ``decode_splits`` / ``decode_split_cap`` (the count, from
shapes only), ``decode_live_pages`` and ``split_range`` (each split's
pages), and ``merge_partials_ref`` (the merge's plain version).  A plain
emulation of the split kernel — per-split partials through
``paged_attention_ref``'s math, then ``merge_partials_ref`` — is held
against the JAX oracle ``repro.kernels.paged_attention.ref.
paged_attention_ref`` on the same numpy inputs.  Tolerances: fp32 1e-6
(outputs are averages of N(0, 1) values; the same terms summed in another
order), int8 pages 2e-5 (the int8 plain path's, ``test_torch_int8.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ref as jax_ref
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.paged_attention.kernel import (
    DECODE_BLOCKS_PER_SM, DECODE_MAX_SPLITS, decode_live_pages,
    decode_split_cap, decode_splits, split_range)
from repro_torch.kernels.paged_attention.ref import (merge_partials_ref,
                                                     ring_positions)
from repro_torch.serving.layouts import quantize_kv

H100_SMS = 132

#: (slots, KV, n_table, ps, window, lengths): qwen's decode at the shapes
#: the card's kernel phase and serve drive give K1 (window 0), mixtral's
#: 4096-token ring (K4) with lengths on both sides of the window, and small
#: rings, slots shorter than the window among them; lengths 0, 1, ps,
#: ps + 1 and a full table in each
SHAPES = [
    (8, 8, 16, 16, 0, [0, 1, 16, 17, 256, 100, 37, 200]),
    (8, 8, 8, 16, 0, [0, 1, 16, 17, 128, 46, 78, 64]),
    (8, 8, 256, 16, 4096, [0, 1, 17, 4095, 4096, 4097, 4200, 8191]),
    (4, 2, 4, 8, 32, [0, 1, 9, 77]),
    (2, 1, 2, 8, 16, [3, 16]),
    (8, 2, 6, 4, 24, [0, 1, 4, 5, 23, 24, 25, 53]),
]


def _table(lengths, n_table, ps, window):
    """Distinct live pages per row (ids from 1), the trash page 0 after."""
    table = np.zeros((len(lengths), n_table), np.int32)
    pid = 1
    for s, length in enumerate(lengths):
        for i in range(decode_live_pages(length, n_table, ps, window)):
            table[s, i] = pid
            pid += 1
    return table


def _check_partition(splits, n_table, ps, window, lengths):
    table = _table(lengths, n_table, ps, window)
    for s, length in enumerate(lengths):
        cells = min(length, window) if window > 0 else length
        key_end = min(cells, n_table * ps)
        n = decode_live_pages(length, n_table, ps, window)
        covered = []
        for z in range(splits):
            p0, p1 = split_range(n, splits, z)
            k0, k1 = p0 * ps, min(p1 * ps, key_end)
            if p1 == p0:
                assert n < splits, (length, z)   # empty only when short
            assert 0 <= k0 and k1 <= cells       # never past the live cells
            assert (table[s, p0:p1] != 0).all()  # never the trash page
            covered += range(p0, p1)
        assert covered == list(range(n))        # each live page once


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_splits_partition_the_live_pages(shape, sms):
    slots, KV, n_table, ps, window, lengths = shape
    splits = decode_splits(slots, KV, n_table, ps, window, sms)
    cap = decode_split_cap(n_table, ps, window)
    assert 1 <= splits <= cap <= DECODE_MAX_SPLITS
    assert cap <= max(1, n_table)
    _check_partition(splits, n_table, ps, window, lengths)


@pytest.mark.parametrize("splits", [2, 3, DECODE_MAX_SPLITS])
@pytest.mark.parametrize("shape", SHAPES)
def test_forced_splits_partition_the_live_pages(shape, splits):
    """The wrapper's ``_splits`` override (card tests) cuts pages the same
    way, empty splits included."""
    _, _, n_table, ps, window, lengths = shape
    _check_partition(splits, n_table, ps, window, lengths)


def test_long_rings_split_to_fill_the_card():
    """mixtral's decode (8 slots x 8 kv-heads = 64 blocks unsplit) splits
    to about two blocks per SM; qwen's short table stops at its cap."""
    splits = decode_splits(8, 8, 256, 16, 4096, H100_SMS)
    assert splits > 1
    assert 8 * 8 * splits >= DECODE_BLOCKS_PER_SM * H100_SMS
    assert decode_splits(8, 8, 16, 16, 0, H100_SMS) \
        == decode_split_cap(16, 16, 0) == 4
    assert decode_splits(64, 8, 256, 16, 0, H100_SMS) == 1


# ---------------------------------------------------------------------------
# numerics: the split kernel's partials and merge against the JAX oracle
# ---------------------------------------------------------------------------

def split_decode(q, k_pages, v_pages, table, lengths, window, splits,
                 k_scale=None, v_scale=None):
    """Plain emulation of the split decode kernel: per slot and split, the
    split's keys (``split_range`` of the live pages) through
    ``paged_attention_ref``'s math into (m, l, acc) — masked keys exactly
    0, an empty split (NEG_INF, 0, 0) — then ``merge_partials_ref``.
    q [slots, H, hd] fp32 -> [slots, H, hd] fp32."""
    slots, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    n_table = table.shape[1]
    G = H // KV
    out = torch.zeros(slots, H, hd)
    for s in range(slots):
        length = int(lengths[s])
        cells = min(length, window) if window > 0 else length
        key_end = min(cells, n_table * ps)
        n = decode_live_pages(length, n_table, ps, window)
        parts = []
        for z in range(splits):
            p0, p1 = split_range(n, splits, z)
            idx = torch.arange(p0 * ps, max(p0 * ps, min(p1 * ps, key_end)))
            pages, off = table[s, idx // ps].long(), idx % ps
            sc = torch.einsum("kgh,tkh->kgt", q[s].reshape(KV, G, hd),
                              k_pages[pages, off].float()) * hd ** -0.5
            if k_scale is not None:
                sc = sc * k_scale[pages, off].float().T[:, None, :]
            if window:
                _, live = ring_positions(torch.tensor([length]), n_table * ps,
                                         window)
                live = live[0, idx]
            else:
                live = idx < length
            sc = torch.where(live, sc, torch.full((), NEG_INF))
            m = (sc.amax(dim=-1) if len(idx)
                 else torch.full((KV, G), NEG_INF))
            base = torch.where(m == NEG_INF, torch.zeros(()), m)
            p = torch.where(live, torch.exp(sc - base[..., None]),
                            torch.zeros(()))
            l = p.sum(dim=-1)
            if v_scale is not None:
                p = p * v_scale[pages, off].float().T[:, None, :]
            acc = torch.einsum("kgt,tkh->kgh", p, v_pages[pages, off].float())
            parts.append((m.reshape(H), l.reshape(H), acc.reshape(H, hd)))
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        out[s] = merge_partials_ref(m, l, acc)
    return out


#: (slots, H, KV, hd, ps, n, window, lengths): contiguous pages with
#: lengths 0, 1, ps, ps + 1 and a full table; a ring (window = n * ps) with
#: lengths on both sides of the window
NUM_CASES = [
    (8, 8, 2, 32, 4, 6, 0, [0, 1, 4, 5, 24, 13, 9, 2]),
    (8, 8, 2, 32, 4, 6, 24, [0, 1, 4, 5, 23, 24, 25, 53]),
]


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", NUM_CASES, ids=["contiguous", "ring"])
def test_split_emulation_matches_jax_oracle(case, int8, splits):
    slots, H, KV, hd, ps, n, window, lengths = case
    rng = np.random.default_rng(3)
    P = slots * n + 1
    q = rng.normal(size=(slots, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    k[0], v[0] = 1e4, -1e4                      # the trash page, poisoned
    table = _table(lengths, n, ps, window)
    lens = np.asarray(lengths, np.int32)
    kw, jkw = {}, {}
    kp, vp = torch.from_numpy(k), torch.from_numpy(v)
    if int8:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        kw = dict(k_scale=ks, v_scale=vs)
        jkw = {n_: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for n_, t in kw.items()}
    got = split_decode(torch.from_numpy(q), kp, vp, torch.from_numpy(table),
                       lens, window, splits, **kw)
    want = np.asarray(jax_ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(table), jnp.asarray(lens), window=window, **jkw))
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0,
                               atol=2e-5 if int8 else 1e-6)
    assert (got[~live] == 0).all()              # a slot of length 0 is 0
