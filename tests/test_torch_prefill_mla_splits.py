"""K2's key walk and split over key tiles, and K6's split over pages, on
the CPU.

The bf16 K2 kernel (``csrc/paged_prefill.cu`` over
``csrc/paged_prefill_body.cuh``) walks each 64-row tile's keys by absolute
position and, when the card would be short of blocks, splits that walk
over ``blockIdx.z``; a second kernel merges the splits' fp32 partials.  The
bf16 K6 kernel (``csrc/paged_mla.cu``) splits every slot's live pages over
``blockIdx.y`` and merges in the same launch.  The kernels run only on the
card; what decides their work is Python here: ``prefill_key_tiles`` (a
tile's key range), ``prefill_splits`` and ``mla_decode_splits`` (the
counts, from shapes and the chunk's host-side bounds only), ``split_range``
(each split's tiles or pages) and ``merge_partials_ref`` (the merge's plain
version).  A plain emulation of each split kernel — per-split partials
through the plain versions' math, then ``merge_partials_ref`` — is held
against the JAX oracles ``repro.kernels.paged_attention.ref.
paged_prefill_ref`` (fp and int8 pages) and ``paged_mla_attention_ref`` on
the same numpy inputs.  Tolerances: fp32 1e-6 (outputs are averages of
N(0, 1) values; the same terms summed in another order), int8 pages 2e-5
(the int8 plain path's, ``test_torch_int8.py``), as in
``test_torch_decode_splits.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ref as jax_ref
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.paged_attention.kernel import (
    MLA_MAX_SPLITS, PREFILL_KEY_TILE, PREFILL_MAX_SPLITS, PREFILL_ROW_TILE,
    PREFILL_SPLIT_BLOCKS_PER_SM, mla_decode_split_cap, mla_decode_splits,
    prefill_key_tiles, prefill_splits, split_range)
from repro_torch.kernels.paged_attention.ref import merge_partials_ref
from repro_torch.serving.layouts import quantize_kv

H100_SMS = 132

#: (S, start, n_valid) of qwen's verify rows and prefill buckets (the
#: card's K2_CASES) and the long-prefix verify that takes the split path;
#: qwen's G 5 and KV 8 with them
K2_CASES = [(5, 0, 5), (5, 37, 3), (16, 0, 11), (16, 32, 16), (64, 0, 40),
            (64, 64, 64), (256, 0, 200), (256, 48, 256), (5, 480, 5)]
G, KV = 5, 8


def _kept_keys(S, start, n_valid):
    """Row r = i * G + g -> the key positions ``paged_prefill_ref``'s mask
    keeps for it (k < start + n_valid and k <= start + i)."""
    return {i * G + g: set(range(min(start + n_valid, start + i + 1)))
            for i in range(n_valid) for g in range(G)}


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_key_walk_covers_exactly_the_kept_keys(case):
    """Each 64-row tile's walk, positions [0, 64 * tiles), holds every key
    a row of it keeps, each of its tiles holds a key some row keeps (no
    dead tile), and the positions it reads, [0, hi), stop at its last kept
    key: nothing past the written bound, where the table's 0-padded tail
    names the trash page, is read."""
    S, start, n_valid = case
    pairs = _kept_keys(S, start, n_valid)
    for r0 in range(0, S * G, PREFILL_ROW_TILE):
        tiles = prefill_key_tiles(r0, G, start, n_valid)
        rows = [r for r in range(r0, r0 + PREFILL_ROW_TILE) if r in pairs]
        if not rows:
            assert tiles == 0               # all padding: no key touched
            continue
        kept = set().union(*(pairs[r] for r in rows))
        hi = start + (rows[-1] // G) + 1    # the kernel's PrefillKeys.hi
        assert max(kept) == hi - 1 and hi <= start + n_valid
        assert max(kept) < tiles * PREFILL_KEY_TILE
        for t in range(tiles):
            tile = range(t * PREFILL_KEY_TILE, (t + 1) * PREFILL_KEY_TILE)
            assert kept.intersection(tile), (r0, t)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("case", K2_CASES)
def test_k2_splits_partition_the_key_tiles(case, sms):
    """Every row tile's key tiles, split by ``prefill_splits``, fall into
    non-empty contiguous ranges that cover each tile once."""
    S, start, n_valid = case
    splits = prefill_splits(S, G, KV, start, n_valid, sms)
    assert 1 <= splits <= PREFILL_MAX_SPLITS
    row_tiles = -(-n_valid * G // PREFILL_ROW_TILE)
    if KV * row_tiles >= PREFILL_SPLIT_BLOCKS_PER_SM * sms:
        assert splits == 1
    for r0 in range(0, n_valid * G, PREFILL_ROW_TILE):
        tiles = prefill_key_tiles(r0, G, start, n_valid)
        covered = []
        for z in range(splits):
            lo, hi = split_range(tiles, splits, z)
            assert hi > lo, f"split {z} of {splits} is empty ({tiles} tiles)"
            covered += range(lo, hi)
        assert covered == list(range(tiles))


def test_k2_long_verify_takes_the_split_path():
    """A verify after a 480-token prefix (8 blocks unsplit) splits to about
    two blocks per SM, bounded by its 8 key tiles; a verify of a short
    prefix has one tile and does not split."""
    assert prefill_splits(5, G, KV, 480, 5, H100_SMS) == 8
    assert prefill_splits(5, G, KV, 37, 3, H100_SMS) == 1


#: (slots, n_table, ps, lengths): deepseek's decode (a table of 8 pages of
#: 16), ps 64, the smoke geometry's 8-token pages and a long table; lengths
#: 0, 1, ps, ps + 1 and a full table in each
MLA_SHAPES = [
    (8, 8, 16, [0, 1, 16, 17, 128, 78, 46, 60]),
    (8, 6, 64, [0, 1, 64, 65, 384, 200, 127, 3]),
    (4, 4, 8, [0, 1, 8, 9]),
    (2, 64, 16, [1024, 17]),
]


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_mla_decode_splits_partition_the_live_pages(shape, sms):
    """Every slot's live pages, split by ``mla_decode_splits``, fall into
    contiguous ranges that cover each live page once and never reach the
    table's trash tail; a split is empty only when its slot has fewer live
    pages than splits (the count comes from shapes, the lengths live on
    the device)."""
    slots, n_table, ps, lengths = shape
    splits = mla_decode_splits(slots, n_table, sms)
    cap = mla_decode_split_cap(n_table)
    assert 1 <= splits <= cap <= min(MLA_MAX_SPLITS, n_table)
    assert splits & (splits - 1) == 0           # a power of two
    for length in lengths:
        n = -(-min(length, n_table * ps) // ps)
        covered = []
        for z in range(splits):
            p0, p1 = split_range(n, splits, z)
            assert p1 > p0 or n < splits, (length, z)
            assert p1 <= n
            covered += range(p0, p1)
        assert covered == list(range(n))


def test_mla_decode_splits_at_deepseek_and_long_tables():
    """deepseek's decode (8 slots, a table of 8 pages) splits in 8, one
    page a split of a full slot: 64 blocks, clusters of 8; more slots
    split less, to about one block per SM."""
    assert mla_decode_splits(8, 8, H100_SMS) == 8
    assert mla_decode_splits(8, 64, H100_SMS) == 8
    assert mla_decode_splits(32, 64, H100_SMS) == 4
    assert mla_decode_splits(64, 64, H100_SMS) == 2
    assert mla_decode_splits(200, 64, H100_SMS) == 1


# ---------------------------------------------------------------------------
# numerics: the split kernels' partials and merge against the JAX oracles
# ---------------------------------------------------------------------------

def _partial(s, live, v):
    """Softmax partial of a split as the kernels keep it: m the max over
    live scores (NEG_INF if none), probabilities exp(s - m) on live keys
    and exactly 0 on masked ones (``p_scale`` applied after the sum for
    int8 values), l their sum, acc their product with v."""
    s = torch.where(live, s, torch.full((), NEG_INF))
    m = s.amax(dim=-1) if s.shape[-1] else torch.full(s.shape[:-1], NEG_INF)
    base = torch.where(m == NEG_INF, torch.zeros(()), m)
    p = torch.where(live, torch.exp(s - base[..., None]), torch.zeros(()))
    return m, p.sum(dim=-1), p


def split_prefill(q, k_pages, v_pages, row, start, n_valid, splits,
                  k_scale=None, v_scale=None):
    """Plain emulation of the split bf16 K2 kernel: per kv-head and 64-row
    tile, the tile's key tiles (``prefill_key_tiles``) cut by
    ``split_range``, each split's positions through ``paged_prefill_ref``'s
    math into (m, l, acc), then ``merge_partials_ref``; padding rows 0.
    q [S, KV * G, hd] fp32 -> [S, KV * G, hd] fp32."""
    S, H, hd = q.shape
    _, ps, kv, _ = k_pages.shape
    g = H // kv
    out = torch.zeros(S, kv, g, hd)
    rows = q.reshape(S, kv, g, hd).permute(1, 0, 2, 3).reshape(kv, S * g, hd)
    for r0 in range(0, n_valid * g, PREFILL_ROW_TILE):
        r = torch.arange(r0, min(r0 + PREFILL_ROW_TILE, n_valid * g))
        qpos = start + r // g
        tiles = prefill_key_tiles(r0, g, start, n_valid)
        hi = int(qpos[-1]) + 1
        parts = []
        for z in range(splits):
            lo_t, hi_t = split_range(tiles, splits, z)
            pos = torch.arange(lo_t * PREFILL_KEY_TILE,
                               min(hi_t * PREFILL_KEY_TILE, hi))
            pages, off = row[pos // ps].long(), pos % ps
            k, v = k_pages[pages, off].float(), v_pages[pages, off].float()
            s = torch.einsum("krh,tkh->krt", rows[:, r], k) * hd ** -0.5
            if k_scale is not None:
                s = s * k_scale[pages, off].float().T[:, None, :]
            live = pos[None, None, :] <= qpos[None, :, None]
            m, l, p = _partial(s, live, v)
            if v_scale is not None:
                p = p * v_scale[pages, off].float().T[:, None, :]
            parts.append((m, l, torch.einsum("krt,tkh->krh", p, v)))
        m, l, acc = (torch.stack(x).reshape(splits, -1, *x[0].shape[2:])
                     for x in zip(*parts))
        merged = merge_partials_ref(m, l, acc).reshape(kv, len(r), hd)
        for j, rr in enumerate(r.tolist()):
            out[rr // g, :, rr % g] = merged[:, j]
    return out.reshape(S, H, hd)


#: (S, start, n_valid, KV, G, hd, ps, n): chunks whose tiles hold 3 and 2
#: key tiles (3 splits of 2 leave one empty, as a forced count may), rows
#: straddling queries (G 3 and 5), a ragged tail
PREFILL_NUM_CASES = [(24, 130, 21, 2, 3, 32, 8, 24),
                     (16, 100, 16, 2, 5, 16, 4, 40)]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", PREFILL_NUM_CASES)
def test_k2_split_emulation_matches_jax_oracle(case, int8, splits):
    S, start, n_valid, kv, g, hd, ps, n = case
    rng = np.random.default_rng(5)
    P = n + 4
    q = rng.normal(size=(S, kv * g, hd)).astype(np.float32)
    k = rng.normal(size=(P, ps, kv, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, kv, hd)).astype(np.float32)
    k[0], v[0] = 1e4, -1e4                      # the trash page, poisoned
    row = np.zeros(n, np.int32)
    held = -(-(start + n_valid) // ps)
    row[:held] = rng.permutation(P - 1)[:held] + 1
    kp, vp = torch.from_numpy(k), torch.from_numpy(v)
    kw, jkw = {}, {}
    if int8:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        kw = dict(k_scale=ks, v_scale=vs)
        jkw = {n_: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for n_, t in kw.items()}
    got = split_prefill(torch.from_numpy(q), kp, vp, torch.from_numpy(row),
                        start, n_valid, splits, **kw)
    want = np.asarray(jax_ref.paged_prefill_ref(
        jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(row), start, n_valid, **jkw))
    np.testing.assert_allclose(got.numpy()[:n_valid], want[:n_valid],
                               rtol=0, atol=2e-5 if int8 else 1e-6)
    assert (got[n_valid:] == 0).all()           # padding rows come back 0


def split_mla(q_lat, q_rope, ckv, krope, table, lengths, scale, splits):
    """Plain emulation of the split bf16 K6 kernel: per slot and split, the
    split's keys (``split_range`` of the live pages) through
    ``paged_mla_attention_ref``'s math into (m, l, acc) — masked keys
    exactly 0, an empty split (NEG_INF, 0, 0) — then
    ``merge_partials_ref``.  -> [slots, H, R] fp32."""
    slots, H, R = q_lat.shape
    ps = ckv.shape[1]
    n_table = table.shape[1]
    out = torch.zeros(slots, H, R)
    for s in range(slots):
        key_end = min(int(lengths[s]), n_table * ps)
        n = -(-key_end // ps)
        parts = []
        for z in range(splits):
            p0, p1 = split_range(n, splits, z)
            pos = torch.arange(p0 * ps, max(p0 * ps, min(p1 * ps, key_end)))
            pages, off = table[s, pos // ps].long(), pos % ps
            c = ckv[pages, off].float()
            sc = (torch.einsum("hr,tr->ht", q_lat[s], c)
                  + torch.einsum("hr,tr->ht", q_rope[s],
                                 krope[pages, off].float())) * scale
            m, l, p = _partial(sc, (pos < key_end)[None, :], c)
            parts.append((m, l, p @ c))
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        out[s] = merge_partials_ref(m, l, acc)
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("ps", [4, 8])
def test_mla_split_emulation_matches_jax_oracle(ps, splits):
    """At the smoke geometry (H 4, R 32, rp 8: the kernel's small
    instantiation), eight slots of lengths 0, 1, ps, ps + 1 and a full
    table among them; 8 splits of 6 pages leave splits empty."""
    H, R, rp = 4, 32, 8
    slots, n = 8, 6
    lengths = np.asarray([0, 1, ps, ps + 1, n * ps, 13, 9, 2], np.int32)
    rng = np.random.default_rng(7)
    P = slots * n + 1
    q_lat = rng.normal(size=(slots, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(slots, H, rp)).astype(np.float32)
    ckv = rng.normal(size=(P, ps, R)).astype(np.float32)
    kr = rng.normal(size=(P, ps, rp)).astype(np.float32)
    ckv[0], kr[0] = 1e4, -1e4                   # the trash page, poisoned
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s, length in enumerate(lengths):
        for i in range(-(-int(length) // ps)):
            table[s, i] = pid
            pid += 1
    scale = (R // 4 + rp) ** -0.5
    got = split_mla(*map(torch.from_numpy, (q_lat, q_rope, ckv, kr, table,
                                            lengths)), scale, splits)
    want = np.asarray(jax_ref.paged_mla_attention_ref(
        *map(jnp.asarray, (q_lat, q_rope, ckv, kr, table, lengths)),
        scale=scale))
    live = lengths > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0,
                               atol=1e-6)
    assert (got[~live] == 0).all()              # a slot of length 0 is 0
