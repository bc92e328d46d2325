"""Paged-attention kernels of the port against the JAX package.

The port's plain versions of K1 (decode) and K2 (chunked prefill) —
``repro_torch.kernels.paged_attention.ref``, which the kernel wrappers run
for CPU tensors — are held against the JAX oracles (``ref.py``) and the
Pallas kernels in interpret mode (``ops.*(use_kernel=True)``, as
``tests/test_paged_attention.py`` runs them) on the same numpy inputs.

Tolerances: fp32 atol 1e-5 (same math, different summation order); bf16
atol 1e-2 (inputs round identically from fp32; outputs may differ by one
bf16 ulp, 2**-8 relative, for |x| < 2).  Prefill rows past ``n_valid`` are
padding and never compared.  The CUDA kernels themselves are held against
these plain versions on the card by ``tests/test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention import ref as jax_ref
from repro_torch.kernels.paged_attention import kernel as port_kernel
from repro_torch.kernels.paged_attention import ops as port_ops

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _decode_case(seed, slots, H, KV, hd, ps, n):
    """Random pool, disjoint per-slot tables padded with the trash page 0,
    lengths that include 1, ps, ps + 1 and a full table where they fit."""
    rng = np.random.default_rng(seed)
    P = slots * n + 1
    q = rng.normal(size=(slots, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    edge = [1, ps, ps + 1, n * ps]
    lengths = np.asarray([min(edge[s], n * ps) if s < len(edge)
                          else rng.integers(1, n * ps + 1)
                          for s in range(slots)], np.int32)
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s in range(slots):
        for i in range(-(-int(lengths[s]) // ps)):
            table[s, i] = pid
            pid += 1
    k[0], v[0] = 1e4, -1e4                 # trash page: must never be read
    return q, k, v, table, lengths


def _prefill_case(seed, H, KV, hd, ps, n, S):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, H, hd)).astype(np.float32)
    k = rng.normal(size=(n + 2, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(n + 2, ps, KV, hd)).astype(np.float32)
    table = np.arange(2, n + 2, dtype=np.int32)
    table[-1] = 0                          # trash-padded tail entry
    k[0], v[0] = 1e4, -1e4
    return q, k, v, table


def _t(x, dtype):
    return torch.from_numpy(x).to(TORCH[dtype])


def _j(x, dtype):
    return jnp.asarray(x).astype(JNP[dtype])


DECODE_CASES = [
    # (slots, H, KV, hd, ps, n)
    (4, 6, 2, 32, 8, 4),       # G = 3
    (3, 4, 4, 16, 4, 3),       # MHA (G = 1)
    (2, 5, 1, 64, 16, 2),      # MQA, G = 5 (qwen's group size)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax_ref_and_pallas(case, dtype):
    slots, H, KV, hd, ps, n = case
    q, k, v, table, lengths = _decode_case(1, *case)
    port = port_ops.paged_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                    torch.from_numpy(table),
                                    torch.from_numpy(lengths),
                                    use_kernel=True)
    got = port.float().numpy()
    want = jax_ref.paged_attention_ref(_j(q, dtype), _j(k, dtype),
                                       _j(v, dtype), table, lengths)
    pallas = jax_ops.paged_attention(_j(q, dtype), _j(k, dtype),
                                     _j(v, dtype), table, lengths,
                                     use_kernel=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=TOL[dtype])


PREFILL_CASES = [
    # (H, KV, hd, ps, n, S, start, n_valid)
    (6, 2, 32, 8, 4, 5, 0, 5),      # verify row, G = 3, cold
    (6, 2, 32, 8, 4, 5, 13, 3),     # verify row after a prefix, ragged
    (4, 2, 32, 8, 5, 16, 10, 13),   # bucket with padded tail, deep start
    (4, 4, 16, 4, 8, 16, 0, 16),    # MHA, full bucket
    (5, 1, 64, 16, 3, 32, 7, 20),   # MQA, G = 5
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_plain_matches_jax_ref_and_pallas(case, dtype):
    H, KV, hd, ps, n, S, start, n_valid = case
    assert start + n_valid <= (n - 1) * ps     # the trash tail stays unread
    q, k, v, table = _prefill_case(2, H, KV, hd, ps, n, S)
    port = port_ops.paged_prefill(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                  torch.from_numpy(table), start, n_valid,
                                  use_kernel=True)
    got = port.float().numpy()[:n_valid]
    want = jax_ref.paged_prefill_ref(_j(q, dtype), _j(k, dtype),
                                     _j(v, dtype), table, start, n_valid)
    pallas = jax_ops.paged_prefill(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                   table, start, n_valid, use_kernel=True,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32)[:n_valid],
                               atol=TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32)[:n_valid],
                               atol=TOL[dtype])


def test_cpu_wrappers_take_plain_versions_without_counting():
    """On CPU tensors the kernel wrappers run the plain versions and launch
    nothing, so their counters stay put."""
    q, k, v, table, lengths = _decode_case(3, 2, 4, 2, 32, 8, 2)
    before = (port_kernel.paged_attention_kernel.launches,
              port_kernel.paged_prefill_kernel.launches)
    a = port_ops.paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(table),
                                 torch.from_numpy(lengths), use_kernel=True)
    b = port_ops.paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(table),
                                 torch.from_numpy(lengths), use_kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    port_ops.paged_prefill(torch.from_numpy(q[0][None].repeat(3, 0)),
                           torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(table[0]), 0, 3, use_kernel=True)
    assert (port_kernel.paged_attention_kernel.launches,
            port_kernel.paged_prefill_kernel.launches) == before
