"""K9's chunked scan, on the CPU.

The K9 kernel (``csrc/lru_scan.cu``) gives a block 32 consecutive channels
of one batch row; the block walks the sequence in super-chunks, each split
over its warps in contiguous runs.  Each lane scans its run from zero into
(P, h_local); the warps' totals fold into each warp's carry, and all of
them carry the last state of a super-chunk into the next; h = h_local + P
carry.  The kernel runs only on the card; what decides its work is Python
here: ``lru_scan_splits`` (shapes only) and ``lru_scan_chunks``.  The tests
hold that the split covers every (b, step, channel) exactly once, and a
plain emulation of the kernel's order of work — every product and sum
rounded on its own, as the kernel's ``__fmul_rn`` / ``__fadd_rn`` — against
the JAX package on the same numpy inputs: ``lru_scan_ref`` and the Pallas
``lru_scan_padded`` in interpret mode (through ``ops.lru_scan``, as
``test_torch_rglru.py`` runs it).

Tolerances: 1e-5 (the JAX kernel tests' bound; the carries regroup the same
fp32 products, and with log_a <= 0 and x ~ N(0, 1) the states stay O(1));
a split whose one run holds the whole sequence equals the port's plain
version bit for bit (the same ops in the same order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import ops as jax_lru_ops
from repro.kernels.rglru_scan.ref import lru_scan_ref as jax_lru_ref
from repro_torch.kernels.rglru_scan.kernel import (
    LRU_CHANNELS, LRU_MAX_WARPS, LRU_SMEM_MAX, LruSplit, lru_scan_chunks,
    lru_scan_smem, lru_scan_splits)
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref


def runs(S, split):
    """Every warp's run, as the kernel cuts it: (chunk k, warp, t0, n) with
    steps [t0, t0 + n)."""
    span = split.warps * split.steps
    for k in range(lru_scan_chunks(S, split)):
        for w in range(split.warps):
            t0 = k * span + w * split.steps
            yield k, w, t0, max(0, min(split.steps, S - t0))


#: (B, S, W): the drive's prompt lengths and its 2,100-token request at
#: recurrentgemma's width, past the window, one step, ragged widths, a batch
COVER_SHAPES = [(1, 17, 2560), (1, 46, 2560), (1, 2049, 2560),
                (1, 2100, 2560), (1, 1, 2560), (1, 46, 2500),
                (2, 100, 129), (3, 2100, 2560)]


#: forced counts: warps a block, super-chunks, both (every one fits the
#: card's shared memory at every ``COVER_SHAPES`` length)
FORCED = [{}, {"warps": 1}, {"warps": 4}, {"chunks": 8},
          {"chunks": 16, "warps": 8}]


@pytest.mark.parametrize("force", FORCED, ids=lambda f: str(f or "picked"))
@pytest.mark.parametrize("shape", COVER_SHAPES)
def test_split_covers_every_element_once(shape, force):
    """The grid (channel tiles, B) and every block's warp runs over every
    super-chunk cover each (b, step, channel) exactly once, at the picked
    split and at forced ones (at most the forced super-chunks, fewer where
    the sequence is short); the split fits the kernel's limits and the
    card's shared memory."""
    B, S, W = shape
    split = lru_scan_splits(S, **force)
    assert 1 <= split.warps <= LRU_MAX_WARPS and split.steps >= 1
    assert split.warps == force.get("warps", lru_scan_splits(S).warps)
    assert lru_scan_chunks(S, split) <= force.get("chunks", S)
    assert lru_scan_smem(S, split) <= LRU_SMEM_MAX
    tiles = -(-W // LRU_CHANNELS)
    covered = np.zeros((B, S, W), np.int32)
    steps = np.zeros(S, np.int32)
    for _, _, t0, n in runs(S, split):
        steps[t0:t0 + n] += 1
    for b in range(B):                      # blockIdx.y
        for tile in range(tiles):           # blockIdx.x
            c0 = tile * LRU_CHANNELS
            covered[b, :, c0:c0 + LRU_CHANNELS] += steps[:, None]
    assert (covered == 1).all()


def test_split_counts_at_the_drive_shapes():
    """The drive's prompts (S 17-46) take one super-chunk, runs of 6-8
    steps; S 2049 / 2100 (past the window) 16 warps streaming 8
    super-chunks of 17-step runs; one step is one run."""
    assert lru_scan_splits(1) == LruSplit(1, 1)
    assert lru_scan_splits(17) == LruSplit(3, 6)
    assert lru_scan_splits(46) == LruSplit(6, 8)
    assert lru_scan_chunks(46, lru_scan_splits(46)) == 1
    for S in (2049, 2100):
        split = lru_scan_splits(S)
        assert split == LruSplit(16, 17)
        assert lru_scan_chunks(S, split) == 8
    assert lru_scan_splits(2049, chunks=2, warps=4) == LruSplit(4, 257)


def emulate_lru_scan(la, x, split):
    """Plain emulation of the K9 kernel's order of work on fp32 [B, S, W]
    tensors: every warp's run scanned from zero into (P, h_local); each
    warp's carry-in through the warps' totals before it, the next
    super-chunk's carry through all of them; h = h_local + P carry.  Each
    torch op rounds on its own, as the kernel's __fmul_rn / __fadd_rn
    do."""
    B, S, W = x.shape
    out = torch.empty_like(x)
    carry = torch.zeros(B, W)

    def fold(c, t):
        return t[0] * c + t[1]

    for k in range(lru_scan_chunks(S, split)):
        local, tot = {}, []
        for kk, w, t0, n in runs(S, split):
            if kk != k:
                continue
            P, h, ps, hs = torch.ones(B, W), torch.zeros(B, W), [], []
            for t in range(t0, t0 + n):
                a = torch.exp(la[:, t])
                h = a * h + x[:, t]
                P = a * P
                ps.append(P)
                hs.append(h)
            local[w] = (t0, ps, hs)
            tot.append((P, h))
        cnext = carry
        for w, (t0, ps, hs) in local.items():
            cw = carry
            for v in range(w):
                cw = fold(cw, tot[v])
            for i, (P, h) in enumerate(zip(ps, hs)):
                out[:, t0 + i] = h + P * cw
        for t in tot:
            cnext = fold(cnext, t)
        carry = cnext
    return out


def _inputs(B, S, W, seed, h0=False):
    """log_a <= 0 and x ~ N(0, 1), as the gates give them; with ``h0``
    the h0 path's inputs (``rglru.rg_lru_scan``): a virtual step 0 with
    log_a = 0 and x = the incoming state."""
    rng = np.random.default_rng(seed)
    la = -np.abs(rng.normal(size=(B, S, W))).astype(np.float32)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    if h0:
        la[:, 0] = 0.0
        x[:, 0] = rng.normal(size=(B, W)).astype(np.float32)
    return la, x


#: (B, S, W, h0, split): forced splits of 1, 2, 4 and 8 super-chunks (the
#: last ones ragged), one warp and many, the picked split at the drive's
#: prompt shape (one super-chunk), ragged widths and batches, and the h0
#: path's virtual step
EMULATED = [
    (2, 70, 40, False, lru_scan_splits(70, chunks=1, warps=3)),
    (2, 70, 40, False, lru_scan_splits(70, chunks=2, warps=4)),
    (1, 70, 40, True, lru_scan_splits(70, chunks=4, warps=3)),
    (2, 70, 40, False, lru_scan_splits(70, chunks=8, warps=3)),
    (3, 97, 33, True, lru_scan_splits(97, chunks=8, warps=1)),
    (1, 46, 129, False, lru_scan_splits(46)),
    (1, 300, 64, False, lru_scan_splits(300, chunks=8, warps=8)),
    (1, 300, 64, True, LruSplit(5, 7)),
]


@pytest.mark.parametrize("B,S,W,h0,split", EMULATED)
def test_emulated_kernel_matches_jax(B, S, W, h0, split):
    """The kernel's order of work equals the JAX oracle and the Pallas
    kernel (interpret mode) within 1e-5; on the h0 path the virtual step
    returns the incoming state exactly."""
    la, x = _inputs(B, S, W, S * W + split.warps, h0)
    got = emulate_lru_scan(torch.from_numpy(la), torch.from_numpy(x),
                           split).numpy()
    want = np.asarray(jax_lru_ref(jnp.asarray(la), jnp.asarray(x)))
    pallas = np.asarray(jax_lru_ops.lru_scan(
        jnp.asarray(la), jnp.asarray(x), interpret=True, block_t=32))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    if h0:
        np.testing.assert_array_equal(got[:, 0], x[:, 0])


@pytest.mark.parametrize("S", [1, 17, 46])
def test_one_run_equals_the_plain_version_bit_for_bit(S):
    """A split whose one warp's run holds the whole sequence rounds as the
    plain version does, and its carry is the zero state: the same result
    bit for bit."""
    la, x = (torch.from_numpy(a) for a in _inputs(2, S, 40, S))
    got = emulate_lru_scan(la, x, LruSplit(1, S))
    assert torch.equal(got, lru_scan_ref(la, x))


@pytest.mark.parametrize("S", [2049, 2100])
def test_emulated_kernel_past_the_window(S):
    """The picked split at the long prompts' lengths (16 warps of 17-step
    runs, 8 super-chunks), and a forced one of 2 super-chunks of 4 long
    runs, at a narrow width: within 1e-5 of the JAX oracle."""
    la, x = _inputs(1, S, 8, S)
    want = np.asarray(jax_lru_ref(jnp.asarray(la), jnp.asarray(x)))
    for split in (lru_scan_splits(S), lru_scan_splits(S, chunks=2, warps=4)):
        got = emulate_lru_scan(torch.from_numpy(la), torch.from_numpy(x),
                               split).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
