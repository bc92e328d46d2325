"""The MoE sorted route's tile table, and the plain PyTorch version of the
grouped GEMM over it (K11).

The route's picks — (token, choice) pairs, ``N * K`` of them — are sorted
by expert (stable, so within an expert by token); the picks of this rank's
local experts ``[first, first + n_local)`` are then cut into tiles of at
most ``TILE_ROWS`` consecutive sorted rows of one expert each.  The table
holds one row per tile, ``(local expert, first row, end row)`` in sorted
positions, and has a length fixed by the shapes, ``tile_bound``: the slots
past the live tiles are empty (end row = first row).  Everything here is
device work of fixed size: no group size is read back to the host.

``moe_grouped_ref`` computes over that table what the kernel computes: per
tile ``act(x W_gate) * (x W_up)`` then ``W_down``, rounded at the points of
``models/moe.py``'s ``_expert`` in the compute dtype, each row weighted in
fp32 by its gate (cast to the compute dtype), and each token's rows summed
from 0.0 in fp32 in ascending expert order.  It runs on any device; the
wrapper (``kernel.py``) takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dot


#: the tile height (MOE_BM in csrc/moe_grouped.cu).  One height serves
#: every shape: on the H100 128-row tiles were no faster anywhere, and
#: slower at deepseek-v2-lite's chunks (PERF.md §6, K11)
TILE_ROWS = 64


def tile_bound(n_picks: int, n_local: int) -> int:
    """The table's length: no grouping of ``n_picks`` rows over ``n_local``
    experts takes more tiles (each expert's last tile is the only partial
    one)."""
    return -(-n_picks // TILE_ROWS) + n_local


def group_picks(flat_e, first: int, n_local: int):
    """flat_e [N*K] int64: every pick's expert (``E`` for a padding token:
    no expert's) -> (order [N*K] int64: the picks sorted by expert, stable;
    tiles [tile_bound, 3] int64: (local expert, first row, end row) in
    sorted positions, the empty slots last).  The group sizes come from
    ``searchsorted`` of the experts' ids into the sorted ids, on the
    device (``bincount`` on CUDA reads its input's maximum back to the
    host)."""
    dev, bm = flat_e.device, TILE_ROWS
    order = torch.argsort(flat_e, stable=True)
    ids = torch.arange(first, first + n_local + 1, device=dev)
    bounds = torch.searchsorted(flat_e[order], ids)      # [n_local + 1]
    counts = bounds[1:] - bounds[:-1]
    ntiles = (counts + bm - 1) // bm
    tend = torch.cumsum(ntiles, 0)                        # each expert's end
    t = torch.arange(tile_bound(flat_e.shape[0], n_local), device=dev)
    e = torch.searchsorted(tend, t, right=True)           # n_local: empty
    ec = e.clamp(max=n_local - 1)
    row0 = bounds[ec] + (t - tend[ec] + ntiles[ec]) * bm
    row1 = torch.where(e < n_local,
                       torch.minimum(row0 + bm, bounds[ec + 1]), row0)
    return order, torch.stack([ec, row0, row1], 1)


def moe_grouped_ref(x, w_gate, w_up, w_down, tok, gate, tiles, pick_e,
                    inv, *, first: int, act: str):
    """x [N, D] in the compute dtype; w_gate, w_up [n_local, D, F], w_down
    [n_local, F, D]; tok [N*K] int64: each sorted row's token; gate
    [N*K]: each sorted row's gate in the compute dtype; tiles:
    ``group_picks``'s; pick_e, inv [N, K] int64: each pick's expert and
    sorted row.  Returns the
    routed sum [N, D] fp32."""
    cd = x.dtype
    N, D = x.shape
    n_local = w_gate.shape[0]
    e, r0, r1 = tiles.unbind(1)
    rows = r0[:, None] + torch.arange(TILE_ROWS, device=x.device)
    live = rows < r1[:, None]
    at = torch.where(live, rows, 0)
    xt = x[tok[at]]                                    # [T, TILE_ROWS, D]
    h = activation(act)(dot(xt, w_gate[e], cd)) * dot(xt, w_up[e], cd)
    y = dot(h, w_down[e], cd).float() * gate[at].to(cd).float()[..., None]
    out = torch.zeros((tok.shape[0] + 1, D), dtype=torch.float32,
                      device=x.device)                # last row: dead rows
    out.index_copy_(0, torch.where(live, rows, tok.shape[0]).reshape(-1),
                    y.reshape(-1, D))
    pe, k = pick_e.sort(dim=1, stable=True)           # ascending expert
    pos = inv.gather(1, k)
    acc = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for j in range(pe.shape[1]):
        mine = (pe[:, j] >= first) & (pe[:, j] < first + n_local)
        acc = torch.where(mine[:, None], acc + out[pos[:, j]], acc)
    return acc
