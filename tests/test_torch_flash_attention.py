"""Kernel K3 (flash attention) and the flash backward against the JAX
package, on the same numpy inputs.

  * the port's ``ref.attention_ref`` and ``ops.flash_attention`` (plain
    version, and the kernel wrapper on CPU tensors) against the JAX Pallas
    kernel run in interpret mode and its jnp oracle ``attention_ref``, over
    causal / windowed masks, GQA groups 1, 2 and 5, a ragged S and
    Sq != Sk;
  * ``flash_vjp._fwd`` (O and L) and the ``FlashAttention`` Function's
    dq / dk / dv on the CPU against ``jax.vjp`` of the JAX
    ``flash_attention_vjp``.

Everything is fp32; tolerance atol 1e-5 (fp32, summation order differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention import ref as jax_ref
from repro.models import flash_vjp as jax_vjp
from repro_torch.kernels.flash_attention import kernel as port_kernel
from repro_torch.kernels.flash_attention import ops as port_ops
from repro_torch.kernels.flash_attention import ref as port_ref
from repro_torch.models import flash_vjp as port_vjp

ATOL = 1e-5

#: (B, Sq, Sk, KV, G, hd, causal, window)
CASES = [
    (1, 16, 16, 2, 1, 16, True, 0),
    (2, 24, 24, 2, 2, 16, True, 0),
    (1, 37, 37, 1, 5, 16, True, 0),       # ragged S, G = 5
    (2, 40, 40, 2, 2, 16, True, 8),       # sliding window
    (1, 24, 40, 2, 5, 32, True, 0),       # Sq != Sk
    (1, 33, 20, 1, 2, 16, False, 0),      # non-causal, Sq > Sk
    (1, 29, 29, 2, 5, 16, False, 6),      # window without causal
]


def _ids(c):
    B, Sq, Sk, KV, G, hd, causal, window = c
    return f"B{B}-Sq{Sq}-Sk{Sk}-KV{KV}-G{G}-hd{hd}-c{int(causal)}-w{window}"


def _inputs(case, seed=0):
    B, Sq, Sk, KV, G, hd, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, KV * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


def _bhsd(x):
    B, S, H, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, hd))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_versions_match_the_pallas_kernel_and_its_oracle(case):
    Sq, Sk, causal, window = case[1], case[2], case[6], case[7]
    q, k, v = _inputs(case)
    # several tiles where 8 divides both lengths; a ragged length runs as
    # one tile (the Pallas kernel reads past a ragged edge in interpret
    # mode, where 0 * NaN poisons the masked keys)
    blk = 8 if Sq % 8 == 0 and Sk % 8 == 0 else 128
    want_kernel = np.asarray(jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=blk, block_k=blk, interpret=True))
    want_ref = np.asarray(jax_ref.attention_ref(
        jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)), jnp.asarray(_bhsd(v)),
        causal=causal, window=window))
    got_ref = port_ref.attention_ref(
        torch.from_numpy(_bhsd(q)), torch.from_numpy(_bhsd(k)),
        torch.from_numpy(_bhsd(v)), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got_ref, want_ref, atol=ATOL)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for use_kernel in (False, True):       # True: the wrapper's CPU path
        got = port_ops.flash_attention(tq, tk, tv, causal=causal,
                                       window=window, use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), want_kernel, atol=ATOL)


def test_kernel_wrapper_on_cpu_returns_the_row_logsumexp():
    """The wrapper's (O, L) on CPU tensors: L equals ``_fwd``'s L."""
    case = (2, 32, 32, 2, 2, 16, True, 0)
    q, k, v = _inputs(case, seed=3)
    B, S, KV, G, hd = 2, 32, 2, 2, 16
    n0 = port_kernel.flash_attention_kernel.launches
    out, lse = port_kernel.flash_attention_kernel(
        *(torch.from_numpy(_bhsd(x)) for x in (q, k, v)), causal=True)
    assert port_kernel.flash_attention_kernel.launches == n0  # no launch
    o5, L = port_vjp._fwd(torch.from_numpy(q).reshape(B, S, KV, G, hd),
                          torch.from_numpy(k), torch.from_numpy(v), True, 0,
                          8, 16)
    np.testing.assert_allclose(
        lse.numpy(), L.permute(0, 2, 3, 1).reshape(B * KV * G, S).numpy(),
        atol=ATOL)
    np.testing.assert_allclose(
        out.numpy(), _bhsd(o5.reshape(B, S, KV * G, hd).numpy()), atol=ATOL)


#: (B, S, KV, G, hd, window, q_block, kv_block) — S = 24 with blocks 8/16
#: pads to 32 (the JAX package's padding rule)
VJP_CASES = [
    (2, 24, 2, 2, 16, 0, 8, 16),
    (1, 32, 1, 5, 16, 0, 16, 8),
    (2, 40, 2, 1, 16, 12, 8, 8),
]


@pytest.mark.parametrize("case", VJP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_fwd_matches_jax(case):
    B, S, KV, G, hd, window, bq, bk = case
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, 32, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, 32, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, 32, KV, hd)).astype(np.float32)
    jo, jL = jax_vjp._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          True, window, bq, bk)
    to, tL = port_vjp._fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), True, window, bq, bk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", VJP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_function_grads_match_jax_vjp(case, use_kernel):
    B, S, KV, G, hd, window, bq, bk = case
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, S, KV * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, S, KV * G, hd)).astype(np.float32)

    def jf(q, k, v):
        return jax_vjp.flash_attention_vjp(q, k, v, causal=True,
                                           window=window, q_block=bq,
                                           kv_block=bk)
    jout, pull = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = pull(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout = port_vjp.flash_attention_vjp(tq, tk, tv, causal=True,
                                        window=window, q_block=bq,
                                        kv_block=bk, use_kernel=use_kernel)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for name, t, j in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=f"d{name}")
