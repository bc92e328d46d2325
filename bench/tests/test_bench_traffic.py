"""The traffic generator: inputs from the seed alone, the same set of
sizes for every seed, and the length distributions of its data file."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.core.traffic import SessionTraffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def spec(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def drain(tr, horizon=1e9, answer_s=1.0):
    """Every request in due order, each completing ``answer_s`` after it
    is due (so a session's turns follow one another)."""
    out = []
    while tr.next_due() is not None and tr.next_due() < horizon:
        for r in tr.pop_due(tr.next_due()):
            out.append(r)
            tr.complete(r, r.due + answer_s)
    return out


def requests(name, seed, span=60.0):
    s = spec(name)
    return drain(SessionTraffic(s, seed, 1000, s["serve"]["max_seq_len"],
                                0.0, span))


@pytest.mark.parametrize("name", ["multiturn_chat", "closed_batch32"])
def test_same_seed_same_inputs(name):
    a, b = requests(name, 2**31 + 5), requests(name, 2**31 + 5)
    assert [(r.due, r.max_new, r.prompt.tolist()) for r in a] == \
        [(r.due, r.max_new, r.prompt.tolist()) for r in b]
    c = requests(name, 2**31 + 6)
    assert [r.prompt.tolist() for r in a] != [r.prompt.tolist() for r in c]


def test_seeds_share_sizes_and_times():
    """Seeds differ in content only: the same sizes at the same times."""
    a, b = (requests("multiturn_chat", seed) for seed in (1, 2**31 + 99))
    assert [(r.session, r.turn, r.due, len(r.prompt), r.max_new)
            for r in a] == [(r.session, r.turn, r.due, len(r.prompt),
                             r.max_new) for r in b]
    assert a[0].prompt.tolist() != b[0].prompt.tolist()


def test_chat_lengths_and_history():
    s = spec("multiturn_chat")
    reqs = requests("multiturn_chat", 7, span=200.0)
    shared = s["shared_prefix_tokens"]
    first = reqs[0].prompt[:shared].tolist()
    by_session = {}
    for r in reqs:
        assert r.prompt[:shared].tolist() == first      # one system prompt
        assert 16 <= r.max_new <= 256
        assert len(r.prompt) + r.max_new <= s["serve"]["max_seq_len"]
        by_session.setdefault(r.session, []).append(r)
    users = []
    for rs in by_session.values():
        for a, b in zip(rs, rs[1:]):
            # each turn re-sends the whole earlier prompt, then more
            assert b.prompt[:len(a.prompt)].tolist() == a.prompt.tolist()
            assert len(b.prompt) >= len(a.prompt) + a.max_new + 32
        users.append(len(rs[0].prompt) - shared)
    turns = [len(SessionTraffic(s, 7, 1000, 6144, 0.0, 200.0).templates[i]
                 .users) for i in by_session]
    assert min(turns) == 2 and max(turns) == 6
    assert 32 <= min(users) and max(users) <= 512
    assert 110 <= np.median(users) <= 230
    assert 70 <= np.median([r.max_new for r in reqs]) <= 125


def test_closed_loop_clients():
    s = spec("closed_batch32")
    spread = s["preroll_s"]
    tr = SessionTraffic(s, 3, 1000, 3072, 0.0, 100.0)
    first = tr.pop_due(spread)
    dues = sorted(r.due for r in first)
    # the clients start at times spread over the pre-roll, not in step,
    # and at the same times whatever the run seed
    assert len(first) == 32 and len(set(dues)) == 32
    assert 0.0 <= dues[0] < 0.2 * spread and 0.8 * spread < dues[-1] < spread
    other = SessionTraffic(s, 4, 1000, 3072, 0.0, 100.0).pop_due(spread)
    assert sorted(r.due for r in other) == dues
    assert tr.pop_due(100.0) == []         # nothing more until one completes
    tr.complete(first[5], 42.5)
    nxt = tr.pop_due(42.5)
    assert [(r.session, r.turn, r.due) for r in nxt] == \
        [(first[5].session, 1, 42.5)]
    lens = [len(r.prompt) for r in first]
    assert 256 <= min(lens) and max(lens) <= 2048
    assert 450 <= np.median(lens) <= 1000
    assert all(256 <= r.max_new <= 1024 for r in first)


def test_nothing_due_after_stop():
    s = spec("multiturn_chat")
    tr = SessionTraffic(s, 1, 1000, 6144, 0.0, 10.0)
    reqs = drain(tr)
    assert reqs and all(r.due < 10.0 for r in reqs)
