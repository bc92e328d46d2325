"""The port's sampler against the JAX package's, bit for bit, on the CPU.

``repro_torch.serving.sampling`` draws threefry2x32 as jax 0.9.0 does
(``fold_in(PRNGKey(seed), idx)``, partitionable bits, fp32 Gumbel noise):

  * the raw bits equal ``jax.random.bits`` exactly, for every seed, index
    and vocabulary width tried;
  * the Gumbel noise equals ``jax.random.gumbel`` within four fp32 ulps
    of max(|noise|, 1): torch's and XLA's ``log`` are different
    approximations and part in the last bit or two, in each of the two
    logs of ``-log(-log(u))`` (near noise 0 the inner log's result is near
    1, hence the max); the most seen here is 2;
  * ``sample_tokens`` rows equal the JAX ``sample_tokens`` rows over a grid
    of temperature, top-k and top-p (no row parts on these inputs: a
    parting needs two perturbed logits within that ulp, or a top-p cumsum
    that rounds across its threshold);
  * sampled qwen-smoke streams from ``Session.generate`` / ``serve`` equal
    the JAX engine's, on the paged and the slotted pool, with speculation
    off and on;
  * ``chip_smoke.py``'s parting witness: the logits it records from the
    serving engine give back every sampled token of every stream, and its
    edge margin reads a top-k edge and a near-tie where they are.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.serving import sampling as jsamp
from repro_torch import api as port_api
from repro_torch.convert import from_jax_params
from repro_torch.serving import sampling as psamp

ARCH = "qwen2.5-14b"
SEEDS = (0, 1, 13, 2 ** 31 - 1)
IDXS = (0, 1, 77, 4096, 2 ** 31 - 1)


def _jax_key(seed, idx):
    return jax.random.fold_in(jax.random.PRNGKey(seed), idx)


def _port_key(seed, idx):
    return psamp.fold_in(torch.tensor([seed]), torch.tensor([idx]))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-sized ops: intra-op threads only contend with the other test
    workers (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: (seed, V): every seed at V of 1, odd and a power of two past it, and
#: qwen2.5-14b's vocabulary once
BITS_CASES = [(s, v) for s in SEEDS for v in (1, 7, 2049)] + [(13, 152064)]


@pytest.mark.parametrize("seed,V", BITS_CASES)
def test_bits_equal_jax(seed, V):
    """Exact: every uint32 of ``jax.random.bits(fold_in(key, idx), (V,))``."""
    for idx in IDXS:
        want = np.asarray(jax.random.bits(_jax_key(seed, idx), (V,),
                                          jnp.uint32)).astype(np.int64)
        got = psamp.random_bits(_port_key(seed, idx), V)[0].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_four_ulps_of_jax(seed):
    """Same bits, same fp32 formula: within four fp32 ulps of
    max(|noise|, 1), two for each log."""
    for idx in IDXS:
        want = np.asarray(jax.random.gumbel(_jax_key(seed, idx), (3001,),
                                            jnp.float32))
        got = psamp.gumbel(_port_key(seed, idx), 3001)[0].numpy()
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        ulps = np.abs(got - want) / ulp
        i = int(ulps.argmax())
        assert ulps[i] <= 4, (idx, i, float(got[i]), float(want[i]))


def test_rows_fold_independently():
    """A batch of rows is each row's own draw (keys are per row)."""
    seeds = torch.tensor(SEEDS[:3])
    idx = torch.tensor([5, 6, 7])
    batch = psamp.random_bits(psamp.fold_in(seeds, idx), 33)
    for r in range(3):
        one = psamp.random_bits(_port_key(int(seeds[r]), int(idx[r])), 33)
        assert torch.equal(batch[r], one[0])


GRID = [(t, k, p) for t in (0.0, 0.3, 1.0, 2.5) for k in (0, 1, 4, 40)
        for p in (1.0, 0.9, 0.4)]


@pytest.mark.parametrize("V", [5, 257])
def test_sample_tokens_rows_equal_jax(V):
    """Every row of the grid (temperature x top_k x top_p, 8 rows each,
    random seeds and sequence indices): the port's token is the JAX
    package's."""
    rng = np.random.default_rng(V)
    jax_rows = jax.jit(jsamp.sample_tokens)
    parted = []
    for t, k, p in GRID:
        S = 8
        logits = (rng.normal(size=(S, V)) * 2.5).astype(np.float32)
        packed = np.stack([jsamp.pack_params(jsamp.SamplingParams(
            temperature=t, top_k=k, top_p=p, seed=int(s)))
            for s in rng.integers(0, 2 ** 31, S)])
        idx = rng.integers(0, 1 << 20, S).astype(np.int32)
        want = np.asarray(jax_rows(
            jnp.asarray(logits), jnp.asarray(packed), jnp.asarray(idx)))
        got = psamp.sample_tokens(torch.from_numpy(logits),
                                  torch.from_numpy(packed),
                                  torch.from_numpy(idx)).numpy()
        parted += [(t, k, p, r) for r in np.nonzero(got != want)[0]]
    assert parted == []


# ---------------------------------------------------------------------------
# Sampled streams: the port's engine against the JAX engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_session():
    return jax_api.load(ARCH, smoke=True, seed=3)


@functools.lru_cache(maxsize=None)
def _port_session():
    sess = port_api.load(ARCH, smoke=True, device="cpu")
    sess.set_params(from_jax_params(jax.tree.map(np.asarray,
                                                 _jax_session().params)))
    return sess


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _sampling(module):
    """Per-request params; the first, on the repetitive prompt, samples
    from its top two at a low temperature, so drafts are proposed and
    verified through the sampler."""
    S = module.SamplingParams
    return [S(temperature=0.3, top_k=2, seed=13),
            S(temperature=1.3, seed=2 ** 31 - 1),
            S(temperature=0.6, top_p=0.5, seed=0),
            S(temperature=1.0, top_k=3, seed=7)]


#: the prompts: one repetitive, so the n-gram drafter proposes
PROMPTS = [([7, 3] * 8)[:14]] + _prompts(21, [9, 23, 5])


@pytest.mark.parametrize("layout,spec", [("paged", False), ("paged", True),
                                         ("slotted", False)])
def test_sampled_streams_equal_jax(layout, spec):
    kw = dict(max_new=16, kv_layout=layout, spec_tokens=4,
              enable_spec=spec)
    js, ps = _jax_session(), _port_session()
    want = js.serve(PROMPTS, sampling=_sampling(jsamp), **kw)
    got = ps.serve(PROMPTS, sampling=_sampling(psamp), **kw)
    assert got == want
    if spec:
        jm, pm = js.engine.metrics, ps.engine.metrics
        assert pm.drafted_tokens > 0
        assert (pm.drafted_tokens, pm.accepted_tokens) == (
            jm.drafted_tokens, jm.accepted_tokens)


def test_sampled_generate_equals_jax():
    sp = dict(temperature=0.9, top_k=20, seed=5)
    want = _jax_session().generate(PROMPTS[1], max_new=16,
                                   sampling=jsamp.SamplingParams(**sp))
    got = _port_session().generate(PROMPTS[1], max_new=16,
                                   sampling=psamp.SamplingParams(**sp))
    assert got == want


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_witness_is_the_serving_draw():
    """Every token of every sampled stream (paged, speculation on: first
    tokens, decode steps and verify rows) is found among the draws
    ``recorded_draws`` kept, at its packed row and index, and the
    recorded logits give it back through ``sample_tokens``."""
    cs = _chip_smoke()
    ps, samp = _port_session(), _sampling(psamp)
    with cs.recorded_draws(torch) as calls:
        outs = ps.serve(PROMPTS, sampling=samp, max_new=16, spec_tokens=4,
                        enable_spec=True)
    assert ps.engine.metrics.drafted_tokens > 0
    for prompt, sp, out in zip(PROMPTS, samp, outs):
        row = torch.from_numpy(psamp.pack_params(sp))
        for j, tok in enumerate(out):
            idx = len(prompt) + j
            lg = cs.served_logits(torch, calls, row, idx, tok, "test")
            again = psamp.sample_tokens(lg[None], row[None],
                                        torch.tensor([idx]))
            assert int(again[0]) == tok
    with pytest.raises(AssertionError, match="not"):
        cs.served_logits(torch, calls, row, len(PROMPTS[-1]),
                         (outs[-1][0] + 1) % 256, "test")


def test_chip_smoke_parting_margin_reads_the_edges():
    """A token at the top-k edge and two tied perturbed scores give margin
    0; two tokens inside the kept set, far from its edge and from each
    other, a margin past the bf16 tie at their top logit."""
    cs = _chip_smoke()
    V = 64
    logits = torch.linspace(8.0, 0.0, V)
    sp = psamp.SamplingParams(temperature=0.5, top_k=10, top_p=1.0, seed=3)
    m, edge = cs.parting_margin(torch, logits, sp, 11, 9, 0)
    assert (m, edge) == (0.0, "top-k edge (9)")
    g = psamp.gumbel(psamp.fold_in(torch.tensor([3], dtype=torch.int32),
                                   torch.tensor([11], dtype=torch.int32)),
                     V)[0]
    tied = logits.clone()
    tied[1] = tied[0] + 0.5 * float(g[0] - g[1])   # equal perturbed scores
    m, edge = cs.parting_margin(torch, tied, sp, 11, 0, 1)
    assert edge == "near-tie" and m < 1e-5
    m, _ = cs.parting_margin(torch, logits, sp, 11, 0, 3)
    assert m > cs.bf16_tie(8.0)
