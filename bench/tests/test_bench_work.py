"""The work counts from shapes: parameters against the program's own
count, trie sharing, decode grouping, and each roofline's FLOPs and
bytes by hand."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.core import work
from bench.core.peaks import HBM_BW, PEAK_FLOPS_BF16
from bench.core.traffic import Req
from repro_torch.configs import get_config
from repro_torch.models.registry import count_params

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name,total_b", [("qwen2.5-14b", 14.77),
                                          ("deepseek-v2-lite-16b", 16.21)])
def test_body_params_against_program(name, total_b):
    c = cfg(name)
    d = work.dims(c)
    mc = get_config(c["arch"])
    table = 2 * d["V"] * d["D"]                  # input table + head
    prog = count_params(mc, active_only=True) - table
    body = work.body_params(d)
    # the program counts norms and biases too (vectors, no products)
    assert 0 <= prog - body < 1e-4 * prog
    assert round(count_params(mc) / 1e9, 2) == total_b


def test_distinct_positions_is_the_trie_size():
    seqs = [np.array(s) for s in ([1, 2, 3, 4], [1, 2, 3, 5], [1, 2], [7])]
    assert work.distinct_positions(seqs) == 6
    assert work.distinct_positions([np.arange(10)] * 3) == 10


def test_decode_groups_by_step():
    a = Req(0, 0, np.arange(5), 3, 0.0)
    a.tokens = [11, 12, 13]
    b = Req(1, 0, np.arange(8), 9, 0.0)
    b.tokens = [21, 22, 23, 24, 25]
    steps = [[(a, 0), (a, 1), (b, 3), (b, 4)], [(a, 2)]]
    g = work.decode_groups(steps)
    assert [[k for _, k in grp] for grp in g] == [[6, 11], [12], [7]]
    assert g[0][0][0].tolist() == list(range(5)) + [11]


def test_roofline_counts_by_hand():
    d = work.dims(cfg("qwen2.5-14b"))
    L, H, KV, hd = d["L"], d["H"], d["KV"], d["hd"]
    # one decode step, two slots sharing 100 prompt tokens
    p = np.arange(100)
    grp = [(np.concatenate([p, [1, 2]]), 102), (np.concatenate([p, [3]]), 101)]
    pos = 100 + 2 + 1
    byt = pos * KV * hd * 2 * 2 + 2 * H * hd * 2 * 2
    fl = 4 * H * hd * 203
    assert np.isclose(work.decode_kernel_time(d, [grp], latent=False),
                      L * max(fl / PEAK_FLOPS_BF16, byt / HBM_BW))
    # a prefill chunk of 512 queries after 1,024 cached keys
    byt = 1536 * KV * hd * 2 * 2 + 512 * H * hd * 2 * 2
    fl = 4 * H * hd * (512 * 1024 + 512 * 513 / 2)
    assert np.isclose(work.prefill_kernel_time(d, [(1024, 512)]),
                      L * max(fl / PEAK_FLOPS_BF16, byt / HBM_BW))
    # latent pages: 576 values a position, the output in the latent space
    m = work.dims(cfg("deepseek-v2-lite-16b"))
    grp = [(np.arange(50), 50)]
    byt = 50 * 576 * 2 + m["H"] * (576 + 512) * 2
    fl = 2 * m["H"] * 50 * (576 + 512)
    assert np.isclose(work.decode_kernel_time(m, [grp], latent=True),
                      m["L"] * max(fl / PEAK_FLOPS_BF16, byt / HBM_BW))
    assert work.roofline_share(0.0, 1.0) is None
    assert work.roofline_share(1.0, 0.0) is None
    assert work.roofline_share(1.0, 4.0) == 25.0


def test_model_flops():
    d = work.dims(cfg("qwen2.5-14b"))
    body, head = 2 * work.body_params(d), 2 * d["D"] * d["V"]
    att = 4 * d["H"] * d["hd"] * d["L"]
    one = [[(np.arange(9), 9)]]
    assert work.model_flops(d, [], one, 0) == body + head + att * 9
    assert work.model_flops(d, [(0, 4)], [], 1) == \
        body * 4 + att * 10 + head
    # a 14.7 B dense model: ~2 x 13.2 G body products a token
    assert 26e9 < body < 28e9
