"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the measured requests that finished — the one with the longest sequence,
then others drawn from the seed until ``MIN_SERVED_TOKENS`` or the
traffic's ``check.max_requests`` — runs through the family's float32
reference once, teacher-forced on each prompt and its served tokens.  At
every served token the reference's logits give its gap: how far the
served token's logit lies below the reference's best, in units of the
spread (standard deviation) of that position's logits.  Two numbers come
of it: the widest gap over the sample, ``logit_gap``, and their mean,
``mean_gap``; the configuration's ``check`` names the ones compared, each
with its limit, and ``judge`` decides ``correct`` from them.

The control (``control=True``) runs the same reference in fp8 (see
``bench/reference/common.py``) in the program's place and reads, at the
same positions, the gap of the token that fp8 puts first;
``control_readings`` puts those numbers under the check's own names, so
that ``judge`` decides the control's ``correct`` as it does the program's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.core.traffic import Req
from bench.reference.common import no_tf32

#: served tokens the sample gathers (up to the traffic's max_requests)
MIN_SERVED_TOKENS = 300


def sample(finished: List[Req], seed: int, min_tokens: int,
           max_requests: int) -> List[Req]:
    """The longest finished request, then others in an order drawn from
    the seed, until the served tokens reach ``min_tokens``."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.tokens),
                                           r.due))
    rest = [r for r in finished if r is not longest]
    order = np.random.default_rng([seed, 5]).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per position: (best - chosen) / std of the reference's logits."""
    best = ref_logits.max(dim=-1).values
    pick = ref_logits.gather(-1, chosen[:, None])[:, 0]
    return (best - pick) / ref_logits.std(dim=-1)


def compare(ref, cfg: Dict, weights, reqs: List[Req], *,
            control: bool = False) -> Dict:
    """``{"logit_gap": widest gap of the served tokens, "tokens": n,
    "requests": m}`` (and ``"control_gap"`` with ``control``)."""
    seqs = [np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int64)])
            for r in reqs]
    wanted = [range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.tokens))
              for r in reqs]
    no_tf32()
    with torch.no_grad():
        ref32 = ref.logits_at(cfg, weights, seqs, wanted)
        dev = ref32[0].device
        served = [torch.as_tensor(r.tokens, device=dev) for r in reqs]
        g = torch.cat([gaps(lg, s) for lg, s in zip(ref32, served)])
        out = {"logit_gap": float(g.max()), "tokens": int(g.numel()),
               "requests": len(reqs), **spread("", g)}
        if control:
            low = ref.logits_at(cfg, weights, seqs, wanted, precision="fp8")
            gc = torch.cat([gaps(lg, lo.argmax(dim=-1))
                            for lg, lo in zip(ref32, low)])
            out.update(control_gap=float(gc.max()), **spread("control_", gc))
    return out


def spread(prefix: str, g: torch.Tensor) -> Dict:
    """How the gaps spread over the sample: their mean and the share of
    tokens that are not the reference's best."""
    return {prefix + "mean_gap": float(g.mean()),
            prefix + "mismatch_share": float((g > 0).float().mean())}


def judge(got: Dict, limits: Dict) -> bool:
    """``correct``: some tokens were compared and every number that the
    configuration's ``check`` names is within its limit."""
    return got.get("tokens", 0) > 0 and all(
        got.get(k) is not None and got[k] <= v for k, v in limits.items())


def control_readings(got: Dict) -> Dict:
    """The control's numbers from ``compare(..., control=True)``, under
    the names the program's carry."""
    return {"logit_gap": got["control_gap"],
            "mean_gap": got["control_mean_gap"],
            "mismatch_share": got["control_mismatch_share"],
            "tokens": got["tokens"], "requests": got["requests"]}
