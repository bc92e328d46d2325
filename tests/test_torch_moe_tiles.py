"""Property tests of the MoE sorted route's tile table
(``kernels/moe_grouped/ref.py`` ``group_picks``): for any picks and any
slice of local experts, the table has ``tile_bound`` slots, its live
tiles come first, each holds 1 to ``TILE_ROWS`` sorted rows of one local
expert, and together they cover every live pick of the slice exactly
once; ``order`` is a stable sort by expert.
"""
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (optional extra)")
from hypothesis import example, given, settings, strategies as st  # noqa: E402

from repro_torch.kernels.moe_grouped import ref  # noqa: E402


@st.composite
def _picks(draw):
    E = draw(st.integers(1, 12))
    n_local = draw(st.integers(1, E))
    first = draw(st.integers(0, E - n_local))
    flat = draw(st.lists(st.integers(0, E), min_size=1, max_size=400))
    return E, first, n_local, flat


@settings(max_examples=60, deadline=None)
@given(_picks())
@example((4, 0, 4, [0] * 128 + [1] * 64 + [4] * 3))    # exact multiples
@example((4, 1, 2, [3] * 129 + [0] * 7))              # one over two tiles
@example((8, 4, 4, [8] * 10))                          # all padding
def test_tile_table_covers_every_live_pick_once(case):
    E, first, n_local, flat = case
    bm = ref.TILE_ROWS
    flat_e = torch.tensor(flat, dtype=torch.int64)
    order, tiles = ref.group_picks(flat_e, first, n_local)
    n = len(flat)
    assert tiles.dtype == torch.int64
    assert tiles.shape == (ref.tile_bound(n, n_local), 3)
    assert sorted(order.tolist()) == list(range(n))
    keys = [(flat[i], i) for i in order.tolist()]
    assert keys == sorted(keys)                       # stable, by expert
    sorted_e = [flat[i] for i in order.tolist()]
    e, r0, r1 = (c.tolist() for c in tiles.unbind(1))
    live = [b > a for a, b in zip(r0, r1)]
    n_live = sum(live)
    assert live == [True] * n_live + [False] * (len(live) - n_live)
    covered = []
    for j in range(n_live):
        assert 0 < r1[j] - r0[j] <= bm and 0 <= e[j] < n_local
        assert all(sorted_e[r] == first + e[j] for r in range(r0[j], r1[j]))
        covered += range(r0[j], r1[j])
    mine = [r for r, x in enumerate(sorted_e) if first <= x < first + n_local]
    assert sorted(covered) == mine and len(set(covered)) == len(covered)
