"""K5's key walk, its split over key tiles and the merge of the splits'
partials, on the CPU.

The bf16 K5 kernel (``csrc/paged_ring_prefill.cu``) walks each block's
keys by absolute position and, when the card would be short of blocks,
splits that walk over ``blockIdx.z``; a second kernel merges the splits'
fp32 partials.  The kernels run only on the card; what decides their work
is Python here: ``prefill_key_tiles`` (the key range of a block),
``prefill_splits`` / ``split_range`` (the split) and
``merge_partials_ref`` (the merge's plain version).  Tolerance: the merge
against a one-pass softmax in fp32, 1e-6 (outputs are averages of N(0, 1)
values; the two sum the same fp32 terms in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.paged_attention.kernel import (
    PREFILL_KEY_TILE, PREFILL_MAX_SPLITS, PREFILL_ROW_TILE,
    PREFILL_SPLIT_BLOCKS_PER_SM,
    prefill_key_tiles, prefill_splits, split_range)
from repro_torch.kernels.paged_attention.ref import (merge_partials_ref,
                                                     ring_positions)

H100_SMS = 132

#: (S, G, KV, start, n_valid, window, n_cells): mixtral's verify rows past
#: its 4096-token window (S = 1..5, the split path), its ragged last chunk
#: of a 4,200-token prompt, its 1024-query chunks (cold and wrapping the
#: ring), a cold short prompt, G = 6 rows straddling 64-row tiles, and
#: small rings — one shorter than the window — as the CPU tests use them
SHAPES = [(s, 6, 8, 4210, s, 4096, 4096) for s in range(1, 6)] + [
    (5, 6, 8, 4210, 2, 4096, 4096), (128, 6, 8, 4096, 104, 4096, 4096),
    (1024, 6, 8, 3584, 1024, 4096, 4096), (1024, 6, 8, 0, 1024, 4096, 4096),
    (37, 6, 8, 3000, 37, 4096, 4096), (16, 6, 8, 0, 11, 4096, 4096),
    (16, 2, 2, 30, 13, 24, 24), (32, 2, 1, 70, 27, 16, 16),
    (21, 6, 2, 40, 19, 32, 24), (8, 1, 8, 10, 5, 16, 16)]


def _plain_keys(S, G, start, n_valid, window, n_cells):
    """The (row, key position) pairs ``paged_ring_prefill_ref``'s mask
    keeps, rows r = i * G + g of one kv-head: ring cells at their ring
    positions, chunk keys at start + j."""
    ring_pos, ring_ok = ring_positions(torch.tensor([start]), n_cells,
                                       window)
    j = torch.arange(S)
    kpos = torch.cat([ring_pos[0], start + j])
    k_ok = torch.cat([ring_ok[0], j < n_valid])
    qpos = start + j
    valid = k_ok[None, :] & (kpos[None, :] <= qpos[:, None]) \
        & (kpos[None, :] > qpos[:, None] - window)
    pairs = {}
    for i in range(n_valid):
        keys = set(kpos[valid[i]].tolist())
        for g in range(G):
            pairs[i * G + g] = keys
    return pairs


@pytest.mark.parametrize("shape", SHAPES)
def test_key_walk_covers_exactly_the_kept_keys(shape):
    """Each block's walk — positions [lo, lo + 64 * tiles) as the kernel
    computes them — holds every key a row of it keeps, and each of its
    tiles holds a key some row keeps (no dead tile)."""
    S, G, KV, start, n_valid, window, n_cells = shape
    pairs = _plain_keys(S, G, start, n_valid, window, n_cells)
    for r0 in range(0, S * G, PREFILL_ROW_TILE):
        tiles = prefill_key_tiles(r0, G, start, n_valid, window)
        rows = [r for r in range(r0, r0 + PREFILL_ROW_TILE) if r in pairs]
        if not rows:
            assert tiles == 0               # all padding: no key touched
            continue
        lo = max(0, start + r0 // G - window + 1)
        kept = set().union(*(pairs[r] for r in rows))
        assert kept and min(kept) >= lo
        assert max(kept) < lo + tiles * PREFILL_KEY_TILE
        for t in range(tiles):
            tile = range(lo + t * PREFILL_KEY_TILE, lo + (t + 1) * PREFILL_KEY_TILE)
            assert kept.intersection(tile), (r0, t)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_splits_cover_every_key_tile_once(shape, sms):
    S, G, KV, start, n_valid, window, _ = shape
    splits = prefill_splits(S, G, KV, start, n_valid, sms, window)
    assert 1 <= splits <= PREFILL_MAX_SPLITS
    row_tiles = -(-n_valid * G // PREFILL_ROW_TILE)
    if KV * row_tiles >= PREFILL_SPLIT_BLOCKS_PER_SM * sms:
        assert splits == 1
    for r0 in range(0, n_valid * G, PREFILL_ROW_TILE):
        tiles = prefill_key_tiles(r0, G, start, n_valid, window)
        covered = []
        for z in range(splits):
            lo, hi = split_range(tiles, splits, z)
            assert hi > lo, f"split {z} of {splits} is empty ({tiles} tiles)"
            covered += range(lo, hi)
        assert covered == list(range(tiles))


def test_verify_rows_take_the_split_path():
    """A verify row on mixtral's ring (8 kv-heads, one 64-row tile) gives 8
    blocks: the split must bring it to about two blocks per SM."""
    for s in range(1, 6):
        splits = prefill_splits(s, 6, 8, 4210, s, H100_SMS, 4096)
        assert splits > 1
        assert 8 * splits >= PREFILL_SPLIT_BLOCKS_PER_SM * H100_SMS


def _partials(scores, live, v, bounds):
    """Per-split softmax partials as the kernel keeps them: m the max over
    live scores (NEG_INF if none), probabilities exp(s - m) on live keys
    and exactly 0 on masked ones, l their sum, acc their product with v."""
    ms, ls, accs = [], [], []
    for lo, hi in bounds:
        s = torch.where(live[:, lo:hi], scores[:, lo:hi],
                        torch.full((), NEG_INF))
        m = s.amax(dim=1) if hi > lo else torch.full((s.shape[0],), NEG_INF)
        base = torch.where(m == NEG_INF, torch.zeros_like(m), m)
        p = torch.where(live[:, lo:hi], torch.exp(s - base[:, None]),
                        torch.zeros(()))
        ms.append(m)
        ls.append(p.sum(dim=1))
        accs.append(p @ v[lo:hi])
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


@pytest.mark.parametrize("splits", [1, 2, 5, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_partials_matches_one_pass_softmax(splits, seed):
    rng = np.random.default_rng(seed)
    rows, T, hd = 40, 4 * 64 + 17, 64
    scores = torch.from_numpy(rng.normal(size=(rows, T)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(T, hd)).astype(np.float32))
    live = torch.from_numpy(rng.random((rows, T)) < 0.3)
    live[0] = False                         # no live key anywhere -> 0
    live[1] = False
    live[1, -3:] = True                     # live keys in the last split only
    live[2] = False
    live[2, :2] = True                      # ... in the first only
    live[3] = True                          # every key
    bounds = [split_range(T, splits, z) for z in range(splits)]
    m, l, acc = _partials(scores, live, v, bounds)
    got = merge_partials_ref(m, l, acc)

    s = torch.where(live, scores, torch.full((), NEG_INF))
    p = torch.softmax(s, dim=1) * live      # one pass; all-masked rows -> 0
    want = p @ v
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert (got[0] == 0).all()
