"""Mixture-of-Experts feed-forward (token-choice top-k routing).

Two modes, with the JAX package's contracts:

  * GShard capacity (training, the default): tokens are dispatched in
    groups with a per-expert capacity ``C``; choices past an expert's
    capacity are dropped.  Dense one-hot dispatch/combine einsums, as the
    JAX package computes them.
  * ``per_token=True`` (every serving path): each token's full top-k runs,
    nothing is dropped, and no token's routing depends on another's — the
    engine's token-identity guarantee across bucket widths, chunk
    boundaries and concurrently decoding slots.  The JAX package computes
    this as a dense pass over all E experts with zero combine weights off
    the top-k.  Two routes here, the same function:

    - sorted (prefill chunks, verify rows): only the selected experts run:
      the (token, choice) pairs are sorted by expert on the device into a
      tile table whose length the shapes fix, and one grouped GEMM runs
      over it (``kernels/moe_grouped``, K11 on CUDA; its plain version
      over the same table on the CPU).  No group size reaches the host and
      no Python loop walks the experts; at many tokens it does K/E of the
      dense route's expert work.  While a profile is active it is the
      ``moe.sorted`` range (``repro_torch.obs.profile_range``);
    - ``dense=True`` (decode steps): the JAX package's dispatch — every
      local expert on every token as batched products over [E_local, N,
      D], combine weights zero off the top-k.  No data-dependent shape and
      no host sync, so a CUDA graph holds it; each step reads every local
      expert's weights.

Numerics copied from the JAX package: router logits in fp32 from the cast
router; softmax, then top-k (ties to the lower expert index); gates
renormalised by ``max(sum, 1e-9)`` and cast to the compute dtype before
they weight an expert's output; the top-k contributions summed in fp32 in
ascending expert order and cast once; shared experts added after.  The
sigmoid router (``MoEConfig.scoring``, DeepSeek-V3's at one group) chooses
the top-k on sigmoid(logits) plus the ``e_score_correction_bias`` leaf and
gates by sigmoid(logits) without it, normalised by ``sum + 1e-20``; either
router's gates are then multiplied by ``routed_scaling``.  Routing, the
held experts' mask and its count are the ``moe.route`` range of a profile.

A device that holds only some experts (``MoEConfig.experts_held``: the
first ``experts_held`` of ``num_experts``, one device's share of an
expert-parallel deployment) routes over all of them and computes its own
experts' part of the result, through the same ``first`` / ``n_local``
bounds as expert parallelism, without the exchange; the picks that land
on its experts are counted on the device (``held_picks``), with no host
read.

Tensor parallelism: expert-parallel where the expert count divides the
model axis (each rank runs its own experts: the router's expert columns
are gathered so every rank routes alike), else each expert's hidden dim
over the model axis (``expert_mlp``); either way the routed outputs are
partial sums that meet in ``from_model`` (the expert-parallel combine),
and the shared experts' row-parallel down projection likewise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_grouped.kernel import moe_grouped
from repro_torch.models.common import (ParamSpec, activation, dot,
                                       from_model, gather_model,
                                       local_offset, to_model)
from repro_torch.obs import profile_range


def moe_specs(cfg):
    m = cfg.moe
    d, f, n = cfg.d_model, m.d_ff_expert, m.held
    specs = {
        "router": ParamSpec((d, m.num_experts), ("embed", "expert"), init="small"),
        "w_gate": ParamSpec((n, d, f), ("expert", "embed", "expert_mlp")),
        "w_up": ParamSpec((n, d, f), ("expert", "embed", "expert_mlp")),
        "w_down": ParamSpec((n, f, d), ("expert", "expert_mlp", "embed2")),
    }
    if m.correction_bias:
        specs["e_score_correction_bias"] = ParamSpec(
            (m.num_experts,), (None,), init="small")
    if m.num_shared_experts:
        fs = m.d_ff_shared or f * m.num_shared_experts
        specs["shared"] = {
            "w_gate": ParamSpec((d, fs), ("embed", "mlp")),
            "w_up": ParamSpec((d, fs), ("embed", "mlp")),
            "w_down": ParamSpec((fs, d), ("mlp", "embed2")),
        }
    return specs


def _choose_group_size(n_tokens: int, num_experts: int) -> int:
    """Pick a dispatch group size keeping the [g,E,C] combine tensor modest."""
    for g in (4096, 2048, 1024, 512, 256, 128):
        if n_tokens % g == 0 and g * num_experts <= 4096 * 16:
            return g
    return n_tokens


def _route(router, xf, K: int):
    """xf [N, D] -> (probs [N, E] fp32, gates [N, K] fp32, experts [N, K]).
    ``torch.sort`` with ``stable=True`` keeps the lower expert index first
    among equal probabilities, as ``lax.top_k`` does."""
    logits = gather_model(torch.matmul(xf.float(), router.float()),
                          "expert")
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, sel = vals[:, :K], idx[:, :K]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates, sel


def _route_sigmoid(m, p, xf):
    """The sigmoid router, as ``_route`` returns: experts chosen on the
    scores plus the correction bias (when ``m.correction_bias``), gates
    the scores without it normalised over the picks."""
    logits = gather_model(torch.matmul(xf.float(), p["router"].float()),
                          "expert")
    probs = torch.sigmoid(logits)
    choice = probs
    if m.correction_bias:
        choice = probs + p["e_score_correction_bias"].float()
    sel = torch.sort(choice, dim=-1, descending=True,
                     stable=True)[1][:, :m.top_k]
    gates = probs.gather(1, sel)
    return probs, gates / (gates.sum(dim=-1, keepdim=True) + 1e-20), sel


def route(m, p, xf):
    """The router of ``m`` (the ``MoEConfig``) on xf [N, D]: (probs,
    gates, experts), the gates times ``routed_scaling``."""
    if m.scoring == "sigmoid":
        probs, gates, sel = _route_sigmoid(m, p, xf)
    else:
        probs, gates, sel = _route(p["router"], xf, m.top_k)
    if m.routed_scaling != 1.0:
        gates = gates * m.routed_scaling
    return probs, gates, sel


#: device -> picks that landed on this device's held experts (an int64
#: counter the router adds to on the device: no host read)
_HELD_PICKS: dict = {}


def held_picks() -> int:
    """Picks that landed on the held experts of the layers that hold only
    some (``MoEConfig.experts_held``), on every device, since the process
    started (reading it syncs the host)."""
    return sum(int(t) for t in _HELD_PICKS.values())


def _count_held(sel, keep, first: int, n_local: int) -> None:
    mine = (sel >= first) & (sel < first + n_local) & keep[:, None]
    t = _HELD_PICKS.get(sel.device)
    if t is None:
        t = _HELD_PICKS[sel.device] = torch.zeros(
            (), dtype=torch.int64, device=sel.device)
    t.add_(mine.sum())


def _expert(act, w_gate, w_up, w_down, x, cd):
    return dot(act(dot(x, w_gate, cd)) * dot(x, w_up, cd), w_down, cd)


def _into_experts(x):
    """Entry of the routed region (tokens, gates) over whichever model
    axis the experts shard on — at most one of the two is."""
    return to_model(to_model(x, "expert"), "expert_mlp")


def _from_experts(y):
    return from_model(from_model(y, "expert"), "expert_mlp")


def _per_token(cfg, p, xf, gates, sel, keep, cd):
    """Drop-free routing: [N, D] in the compute dtype.  Padding tokens
    (``keep`` False) route nowhere.  The grouping and the grouped GEMM
    are the ``moe.sorted`` range of a profile."""
    E = cfg.moe.num_experts
    first = local_offset(cfg.moe.held, "expert")  # this rank's: first + i
    with profile_range("moe.sorted"):
        flat_e = torch.where(keep[:, None], sel, E).reshape(-1)  # E: nowhere
        acc = moe_grouped(xf, p["w_gate"], p["w_up"], p["w_down"], flat_e,
                          gates, first=first, act=cfg.act)
    return _from_experts(acc).to(cd)


def _dense(cfg, p, xf, gates, sel, keep, cd):
    """Drop-free routing as the JAX package computes it (g = 1, C = 1): [N,
    D] in the compute dtype.  Each local expert runs on every token row
    whose combine weight for it (its gate in the compute dtype, 0 off the
    token's top-k and for padding) is nonzero — the reference's dispatch
    mask — and the weighted outputs sum in fp32, cast once."""
    E = cfg.moe.num_experts
    first = local_offset(cfg.moe.held, "expert")  # this rank's: first + i
    n_local = p["w_gate"].shape[0]
    combine = torch.zeros((xf.shape[0], E), dtype=cd, device=xf.device)
    combine = combine.scatter(1, sel, gates.to(cd)) * keep[:, None]
    w = combine[:, first:first + n_local].t()                    # [E_l, N]
    xe = xf[None] * (w > 0)[..., None].to(cd)                    # [E_l, N, D]
    ye = _expert(activation(cfg.act), p["w_gate"], p["w_up"], p["w_down"],
                 xe, cd)
    acc = torch.einsum("end,en->nd", ye.float(), w.float())
    return _from_experts(acc).to(cd)


def _capacity(cfg, p, xf, gates, onehot, G: int, g: int, cd):
    """GShard capacity dispatch (choice-major priority): [N, D]."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    C = min(max(int(g * K / E * m.capacity_factor), 1), g)
    oh = onehot.reshape(G, g, K, E)
    prio = oh.permute(0, 2, 1, 3).reshape(G, K * g, E)           # choice-major
    pos = torch.cumsum(prio, dim=1) * prio - 1                    # position in expert
    pos = pos.reshape(G, K, g, E).permute(0, 2, 1, 3)             # [G,g,K,E]
    keep = (pos >= 0) & (pos < C)
    pos = torch.where(keep, pos, 0)
    slot = F.one_hot(pos.long(), C).to(cd) * keep[..., None].to(cd)
    combine = torch.einsum(
        "gtke,gtkec->gtec",
        (gates.reshape(G, g, K)[..., None] * oh.float()).to(cd), slot)
    # this rank's experts (all of them unless expert-parallel)
    first, n_local = local_offset(m.held, "expert"), p["w_gate"].shape[0]
    combine = combine[:, :, first:first + n_local]
    dispatch = (combine > 0).to(cd)
    act = activation(cfg.act)
    xe = torch.einsum("gtd,gtec->gecd", xf.reshape(G, g, -1), dispatch)
    h = act(torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(cd))) * \
        torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(cd))
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(cd))
    y = torch.einsum("gecd,gtec->gtd", ye, combine).reshape(G * g, -1)
    return _from_experts(y)


def moe_apply(cfg, p, x, *, n_valid: Optional[int] = None,
              per_token: bool = False,
              dense: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (y [B,S,D], aux_loss scalar fp32).

    ``n_valid`` (serving prefill): positions >= n_valid along S are a
    masked bucket tail — their routing is zeroed before capacity
    accounting, so padding never displaces a real token (their own outputs
    are garbage either way; the engine masks them downstream).
    ``per_token``: drop-free per-token routing (see the module docstring),
    on the sorted route, or with ``dense`` on the dense route (decode).
    The Switch load-balance aux loss is the JAX package's in both modes.
    """
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    cd = x.dtype
    N = B * S
    xf = x.reshape(N, D)
    with profile_range("moe.route"):
        # expert-parallel: the router's columns are this rank's experts
        probs, gates, sel = route(m, p, to_model(xf, "expert"))
        keep = torch.ones((N,), dtype=torch.bool, device=x.device)
        if n_valid is not None:
            keep = (torch.arange(S, device=x.device) < n_valid).repeat(B)
        if m.held < E:
            _count_held(sel, keep, local_offset(m.held, "expert"),
                        p["w_gate"].shape[0])
    # one_hot by comparison: F.one_hot reads the class bounds back to the
    # host on the CPU
    onehot = ((sel[..., None] == torch.arange(E, device=x.device)).long()
              * keep[:, None, None])                              # [N,K,E]

    g = 1 if per_token else _choose_group_size(N, E)
    G = N // g
    xe, ge = _into_experts(xf), _into_experts(gates)
    if per_token and dense:
        y = _dense(cfg, p, xe, ge, sel, keep, cd)
    elif per_token:
        y = _per_token(cfg, p, xe, ge, sel, keep, cd)
    else:
        y = _capacity(cfg, p, xe, ge, onehot, G, g, cd)
    y = y.reshape(B, S, D)

    if m.num_shared_experts:
        sh = p["shared"]
        y = y + from_model(_expert(activation(cfg.act), sh["w_gate"],
                                   sh["w_up"], sh["w_down"],
                                   to_model(x, "mlp"), cd), "mlp")

    # Switch load-balance auxiliary loss, per dispatch group
    frac = onehot.float().reshape(G, g * K, E).mean(dim=1)        # [G,E]
    pmean = probs.reshape(G, g, E).mean(dim=1)                    # [G,E]
    aux = E * torch.mean(torch.sum(frac * pmean, dim=-1)) / K
    return y, aux.float()
