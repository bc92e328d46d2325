"""Wrapper of the hand-written CUDA grouped GEMM of the MoE sorted route
(K11).

``moe_grouped`` runs the routed experts of ``models/moe.py``'s sorted route
(prefill chunks, verify rows): it groups the picks by expert into the tile
table of ``ref.group_picks`` on the device, then, for CUDA tensors,
launches ``csrc/moe_grouped.cu`` — the gate and up products fused, the down
product, then the per-token combine — three kernels over that table, with
no host read and no per-expert loop.  For tensors on the CPU — and only
there — it runs the plain version over the same table
(``ref.moe_grouped_ref``).  For CUDA tensors it checks device, dtype,
shape, contiguity and alignment, allocates its outputs and scratch with
``torch.empty``, launches on the current stream, raises if a launch was
refused, and counts each launch (``launches``; ``launches_by`` "gate_up",
"down", "combine"); there is no fallback.  It has no backward, so it
raises on inputs that require grad under grad mode
(``common.refuse_grad``).  The library builds from the repo's sources on
the first CUDA launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (KERNEL_DTYPES, check_tensor,
                                        count_launch, lib_fn, raise_on,
                                        refuse_grad)
from repro_torch.kernels.moe_grouped.ref import group_picks, moe_grouped_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the kernel's gate activation, by ``models.common.activation``'s names
#: (every MoE configuration's)
SILU = ("silu", "swiglu")
#: the most choices a token (MOE_MAX_K in csrc/moe_grouped.cu)
MAX_TOP_K = 16


def moe_grouped(x, w_gate, w_up, w_down, flat_e, gates, *, first: int,
                act: str):
    """K11.  x [N, D] in the compute dtype; w_gate, w_up [n_local, D, F],
    w_down [n_local, F, D] (this rank's experts, ``first`` the first of
    them); flat_e [N*K] int64: each pick's expert (``E`` for padding);
    gates [N, K]; act: the gate activation (silu).  Returns the routed
    sum [N, D] fp32: each token's picks of the local experts, weighted by
    their gates, summed in ascending expert order."""
    N, D = x.shape
    K = gates.shape[1]
    n_local = w_gate.shape[0]
    cd = x.dtype
    order, tiles = group_picks(flat_e, first, n_local)
    tok = order // K
    gate = gates.to(cd).reshape(-1)[order]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(N * K, device=x.device))
    if x.device.type == "cpu":
        return moe_grouped_ref(x, w_gate, w_up, w_down, tok, gate, tiles,
                               flat_e.view(N, K), inv.view(N, K),
                               first=first, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped MoE kernel for {x.device}")
    refuse_grad("moe_grouped (K11)", x, w_gate, w_up, w_down, gates)
    if cd not in KERNEL_DTYPES:
        raise ValueError(f"moe_grouped takes {list(KERNEL_DTYPES)}, not {cd}")
    if act not in SILU:
        raise ValueError(f"moe_grouped takes silu gates, not {act!r}")
    if K > MAX_TOP_K:
        raise ValueError(f"top-{K} > {MAX_TOP_K}")
    F = w_gate.shape[2]
    check_tensor(x, "x", cd, x.device, 2)
    check_tensor(flat_e, "flat_e", torch.int64, x.device, 1)
    for w, what, shape in ((w_gate, "w_gate", (n_local, D, F)),
                           (w_up, "w_up", (n_local, D, F)),
                           (w_down, "w_down", (n_local, F, D))):
        check_tensor(w, what, cd, x.device, 3)
        if tuple(w.shape) != shape:
            raise ValueError(f"{what} is {tuple(w.shape)}, expected {shape}")
    if D % 8 or F % 8:
        raise ValueError(f"D {D} and F {F} must be multiples of 8 (16-byte "
                         "rows)")
    if any(t.data_ptr() % 16 for t in (x, w_gate, w_up, w_down)):
        raise ValueError("x and the expert weights must be 16-byte aligned")
    h = torch.empty((N * K, F), dtype=cd, device=x.device)
    rows = torch.empty((N * K, D), dtype=torch.float32, device=x.device)
    y = torch.empty((N, D), dtype=torch.float32, device=x.device)
    fn = lib_fn("moe_grouped", "moe_grouped_launch",
                [_P] * 12 + [_I] * 8 + [_P])
    err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
             w_down.data_ptr(), tok.data_ptr(), gate.data_ptr(),
             tiles.data_ptr(), flat_e.data_ptr(), inv.data_ptr(),
             h.data_ptr(), rows.data_ptr(), y.data_ptr(), N, K, D, F,
             tiles.shape[0], first, n_local, KERNEL_DTYPES[cd],
             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "moe_grouped")
    for kind in ("gate_up", "down", "combine"):
        count_launch(moe_grouped, kind)
    return y


moe_grouped.launches = 0
moe_grouped.launches_by = {}
