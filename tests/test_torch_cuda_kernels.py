"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without an NVIDIA GPU; on the card run

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda_kernels.py

This file imports torch and the port only (no jax), so it runs where the
JAX package is not installed.  Tolerances: fp32 1e-5; bf16 1e-2 (kernel
and plain version both accumulate in fp32 and round once to bf16, so they
may differ by one bf16 ulp); K3's row logsumexp rtol 1e-4 (the same fp32
terms summed in another order); K3's gradients 1e-4 of their largest
magnitude (fp32); K6/K7 as K1/K2 (fp32 1e-5, bf16 1e-2); K9 (fp32) 1e-5
of the largest |h| (the same sequential recurrence; expf may differ in the
last ulp); K10 (fp32) 1e-4 of the largest |out| (the reference sums each
output over the state column in another order), its final state exact;
K4 / K5 / K8 as K1 / K2 (the same fused int8 dequant in kernel and plain
version); K1 / K4 / K8 and K6 split over pages, and K2 / K8 and K7 over
key tiles, against unsplit as K1 (the splits' partials merge the same fp32
terms in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.paged_attention import kernel as port_kernel
from repro_torch.kernels.paged_attention import ops as port_ops
from repro_torch.kernels.rglru_scan import kernel as lru_kernel
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.flash_vjp import flash_attention_vjp

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "CPU mode; run on the card with `pytest -m cuda`)")
    # the fp32 plain versions must not round through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(x, dtype, dev):
    return torch.from_numpy(x).to(TORCH[dtype]).to(dev)


def _decode_case(seed, slots, H, KV, hd, ps, n):
    """Disjoint per-slot tables padded with the trash page 0 (filled with
    garbage that must never be read); lengths include 1, ps, ps + 1 and a
    full table."""
    rng = np.random.default_rng(seed)
    P = slots * n + 1
    q = rng.normal(size=(slots, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    edge = [1, ps, ps + 1, n * ps]
    lengths = np.asarray([edge[s] if s < len(edge)
                          else rng.integers(1, n * ps + 1)
                          for s in range(slots)], np.int32)
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s in range(slots):
        for i in range(-(-int(lengths[s]) // ps)):
            table[s, i] = pid
            pid += 1
    k[0], v[0] = 1e4, -1e4
    return q, k, v, table, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,hd", [(40, 8, 128), (24, 8, 64), (8, 8, 256)])
def test_cuda_decode_kernel_matches_plain(dtype, H, KV, hd):
    dev = _cuda()
    q, k, v, table, lengths = _decode_case(4, 8, H, KV, hd, 16, 6)
    args = (_t(q, dtype, dev), _t(k, dtype, dev), _t(v, dtype, dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev))
    n0 = port_kernel.paged_attention_kernel.launches
    out = port_ops.paged_attention(*args, use_kernel=True)
    want = port_ops.paged_attention(*args, use_kernel=False)
    assert port_kernel.paged_attention_kernel.launches == n0 + 1
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,start,n_valid", [(5, 37, 3), (5, 0, 5),
                                             (16, 0, 11), (64, 16, 64),
                                             (256, 0, 200)])
def test_cuda_prefill_kernel_matches_plain(dtype, S, start, n_valid):
    dev = _cuda()
    rng = np.random.default_rng(5)
    n, ps, H, KV, hd = 20, 16, 40, 8, 128
    q = rng.normal(size=(S, H, hd)).astype(np.float32)
    k = rng.normal(size=(n + 2, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(n + 2, ps, KV, hd)).astype(np.float32)
    k[0], v[0] = 1e4, -1e4
    table = np.arange(2, n + 2, dtype=np.int32)
    table[-1] = 0                          # trash-padded tail entry
    assert start + n_valid <= (n - 1) * ps
    args = (_t(q, dtype, dev), _t(k, dtype, dev), _t(v, dtype, dev),
            torch.from_numpy(table).to(dev), start, n_valid)
    n0 = port_kernel.paged_prefill_kernel.launches
    out = port_ops.paged_prefill(*args, use_kernel=True)
    want = port_ops.paged_prefill(*args, use_kernel=False)
    assert port_kernel.paged_prefill_kernel.launches == n0 + 1
    torch.testing.assert_close(out[:n_valid].float(),
                               want[:n_valid].float(), rtol=0,
                               atol=TOL[dtype])
    assert (out[n_valid:] == 0).all()      # padding rows come back 0


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    q = torch.zeros((2, 4, 16), device=dev)
    pages = torch.zeros((3, 4, 2, 16), device=dev)
    table = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    lengths = torch.ones((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        port_ops.paged_attention(q, pages, pages, table, lengths,
                                 use_kernel=True)
    q = torch.zeros((2, 4, 64), device=dev)
    pages = torch.zeros((3, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="int32"):
        port_ops.paged_attention(q, pages, pages, table.long(), lengths,
                                 use_kernel=True)
    with pytest.raises(ValueError, match="GQA group"):
        port_ops.paged_prefill(torch.zeros((5, 18, 64), device=dev),
                               pages[:, :, :1].contiguous(),
                               pages[:, :, :1].contiguous(), table[0], 0, 5,
                               use_kernel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(20, 4), (10, 2)],
                         ids=["model2", "model4"])
def test_cuda_kernels_at_qwen_per_rank_heads(dtype, H, KV):
    """qwen2.5-14b's 40 query / 8 KV heads split whole over a model axis
    of 2 (20 / 4 a rank) and 4 (10 / 2): K1 decode, K2 chunked prefill
    and K3 flash attention each hold to their plain versions at the
    rank's head counts (hd 128)."""
    dev = _cuda()
    hd, ps = 128, 16
    q, k, v, table, lengths = _decode_case(8, 8, H, KV, hd, ps, 6)
    args = (_t(q, dtype, dev), _t(k, dtype, dev), _t(v, dtype, dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev))
    out = port_ops.paged_attention(*args, use_kernel=True)
    torch.testing.assert_close(
        out.float(), port_ops.paged_attention(*args, use_kernel=False).float(),
        rtol=0, atol=TOL[dtype])
    rng = np.random.default_rng(9)
    n, S, start, n_valid = 12, 64, 32, 50
    pq = rng.normal(size=(S, H, hd)).astype(np.float32)
    pk = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    pv = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    pk[0], pv[0] = 1e4, -1e4
    pargs = (_t(pq, dtype, dev), _t(pk, dtype, dev), _t(pv, dtype, dev),
             torch.arange(1, n + 1, dtype=torch.int32, device=dev), start,
             n_valid)
    out = port_ops.paged_prefill(*pargs, use_kernel=True)
    want = port_ops.paged_prefill(*pargs, use_kernel=False)
    torch.testing.assert_close(out[:n_valid].float(),
                               want[:n_valid].float(), rtol=0,
                               atol=TOL[dtype])
    fq = _t(rng.normal(size=(2 * H, 300, hd)).astype(np.float32), dtype, dev)
    fk = _t(rng.normal(size=(2 * KV, 300, hd)).astype(np.float32), dtype, dev)
    fv = _t(rng.normal(size=(2 * KV, 300, hd)).astype(np.float32), dtype, dev)
    out, _ = flash_kernel.flash_attention_kernel(fq, fk, fv, causal=True,
                                                 window=0)
    want = flash_ref.attention_ref(fq, fk, fv, causal=True, window=0)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,H,KV,hd,causal,window", [
    (256, 256, 40, 8, 128, True, 0), (200, 200, 8, 2, 64, True, 48),
    (100, 160, 4, 4, 128, False, 0), (1000, 1000, 10, 2, 128, True, 0),
    (130, 130, 6, 1, 64, False, 40),
    # recurrentgemma's local attention: hd 256, one kv head, window 2048
    (46, 46, 10, 1, 256, True, 2048), (2100, 2100, 10, 1, 256, True, 2048),
    (300, 300, 10, 1, 256, True, 100),
    # Sq != Sk (causal from position 0 on both axes), ragged lengths at
    # every head dim, window edges inside a key tile
    (160, 100, 8, 2, 64, True, 0), (77, 300, 4, 2, 128, True, 0),
    (129, 129, 4, 1, 256, True, 64), (65, 200, 4, 4, 256, False, 0),
    (333, 333, 8, 8, 128, True, 65), (50, 64, 4, 2, 64, False, 20),
    # whisper-tiny: the bidirectional encoder over 1500 frames (a 28-key
    # tail tile), the cross-attention of a 16-token prompt and of one
    # decode query against them; pixtral-12b: causal over 1,024 image
    # tokens and 32 text tokens at hd 128
    (1500, 1500, 6, 6, 64, False, 0), (16, 1500, 6, 6, 64, False, 0),
    (1, 1500, 6, 6, 64, False, 0), (1056, 1056, 32, 8, 128, True, 0)])
def test_cuda_flash_kernel_matches_plain(dtype, Sq, Sk, H, KV, hd, causal,
                                         window):
    dev = _cuda()
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(2 * H, Sq, hd)).astype(np.float32), dtype, dev)
    k = _t(rng.normal(size=(2 * KV, Sk, hd)).astype(np.float32), dtype, dev)
    v = _t(rng.normal(size=(2 * KV, Sk, hd)).astype(np.float32), dtype, dev)
    n0 = flash_kernel.flash_attention_kernel.launches
    out, lse = flash_kernel.flash_attention_kernel(q, k, v, causal=causal,
                                                   window=window)
    assert flash_kernel.flash_attention_kernel.launches == n0 + 1
    want = flash_ref.attention_ref(q, k, v, causal=causal, window=window)
    want_lse = flash_ref.attention_lse_ref(q, k, causal=causal,
                                           window=window)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(256, 0), (200, 64)])
def test_cuda_flash_function_grads_match_plain(S, window):
    """The autograd Function with K3 in its forward against autograd
    through the plain version (fp32)."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    B, H, KV, hd = 2, 8, 2, 64
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]
    do = torch.from_numpy(arrs[3]).to(dev)
    xs = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrs[:3]]
    n0 = flash_kernel.flash_attention_kernel.launches
    out = flash_attention_vjp(*xs, window=window, q_block=64, kv_block=128,
                              use_kernel=True)
    assert flash_kernel.flash_attention_kernel.launches == n0 + 1
    got = torch.autograd.grad(out, xs, do)
    ys = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrs[:3]]
    ref_out = flash_ops.flash_attention(*ys, window=window, use_kernel=False)
    want = torch.autograd.grad(ref_out, ys, do)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("S,q_block,kv_block", [(200, 64, 128),
                                                (1500, 512, 1024)])
def test_cuda_flash_function_bidirectional_over_padding(S, q_block,
                                                        kv_block):
    """whisper's encoder in training: the autograd Function with
    ``causal=False`` over a length its tiles pad (200 -> 256, 1500 ->
    2048); K3 runs on the real rows only, so no padding key is attended.
    Against autograd through the plain version (fp32)."""
    dev = _cuda()
    rng = np.random.default_rng(9)
    B, H, KV, hd = 2, 6, 6, 64
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]
    do = torch.from_numpy(arrs[3]).to(dev)
    xs = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrs[:3]]
    n0 = flash_kernel.flash_attention_kernel.launches
    out = flash_attention_vjp(*xs, causal=False, q_block=q_block,
                              kv_block=kv_block, use_kernel=True)
    assert flash_kernel.flash_attention_kernel.launches == n0 + 1
    got = torch.autograd.grad(out, xs, do)
    ys = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrs[:3]]
    ref_out = flash_ops.flash_attention(*ys, causal=False, use_kernel=False)
    want = torch.autograd.grad(ref_out, ys, do)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", [(10, 1, 256), (40, 8, 128)])
def test_cuda_flash_model_layout_batch_one(H, KV, hd):
    """The model-layout entry point at batch 1 (the serving prefill's),
    where [B, S, H, hd] -> [B*H, S, hd] must still hand the kernel
    contiguous rows."""
    dev = _cuda()
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.normal(size=(1, 46, n, hd)).astype(np.float32),
                  "bfloat16", dev) for n in (H, KV, KV))
    out = flash_ops.flash_attention(q, k, v, window=2048, use_kernel=True)
    want = flash_ops.flash_attention(q, k, v, window=2048, use_kernel=False)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL["bfloat16"])


@pytest.mark.cuda
def test_cuda_flash_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    q = torch.zeros((4, 16, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_kernel.flash_attention_kernel(q, q[:2], q[:2])
    q = torch.zeros((4, 16, 64), device=dev)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_kernel.flash_attention_kernel(q, q[:3], q[:3])
    with pytest.raises(ValueError, match="dtype"):
        flash_kernel.flash_attention_kernel(q, q[:2].half(), q[:2].half())


def _mla_pages(rng, P, ps, R, rp):
    """Latent pages with page 0 (the trash page) full of values that would
    swamp any score that read them."""
    ckv = rng.normal(size=(P, ps, R)).astype(np.float32)
    kr = rng.normal(size=(P, ps, rp)).astype(np.float32)
    ckv[0], kr[0] = 1e4, -1e4
    return ckv, kr


#: (H, R, rp): deepseek-v2-lite at full width, and the smoke geometry
MLA_GEOMS = [(16, 512, 64), (4, 32, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,R,rp", MLA_GEOMS)
@pytest.mark.parametrize("ps", [16, 64])
def test_cuda_mla_decode_kernel_matches_plain(dtype, H, R, rp, ps):
    dev = _cuda()
    rng = np.random.default_rng(8)
    slots, n = 8, 6
    lengths = np.asarray([1, ps, ps + 1, n * ps, 3 * ps - 5, 37 % (n * ps),
                          2 * ps, 0], np.int32)
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s in range(slots):
        for i in range(-(-int(lengths[s]) // ps)):
            table[s, i] = pid
            pid += 1
    ckv, kr = _mla_pages(rng, slots * n + 1, ps, R, rp)
    q_lat = rng.normal(size=(slots, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(slots, H, rp)).astype(np.float32)
    args = (_t(q_lat, dtype, dev), _t(q_rope, dtype, dev),
            _t(ckv, dtype, dev), _t(kr, dtype, dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev))
    scale = 192 ** -0.5
    n0 = port_kernel.paged_mla_kernel.launches
    out = port_ops.paged_mla_attention(*args, scale=scale, use_kernel=True)
    want = port_ops.paged_mla_attention(*args, scale=scale, use_kernel=False)
    assert port_kernel.paged_mla_kernel.launches == n0 + 1
    live = torch.from_numpy(lengths > 0).to(dev)
    torch.testing.assert_close(out[live].float(), want[live].float(), rtol=0,
                               atol=TOL[dtype])
    assert (out[~live] == 0).all()         # a slot of length 0 writes 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,R,rp", MLA_GEOMS)
@pytest.mark.parametrize("S,start,n_valid", [(5, 37, 3), (5, 0, 5),
                                             (16, 0, 11), (64, 16, 64)])
def test_cuda_mla_prefill_kernel_matches_plain(dtype, H, R, rp, S, start,
                                               n_valid):
    dev = _cuda()
    rng = np.random.default_rng(9)
    n, ps = 8, 16
    ckv, kr = _mla_pages(rng, n + 2, ps, R, rp)
    table = np.arange(2, n + 2, dtype=np.int32)
    table[-1] = 0                          # trash-padded tail entry
    assert start + n_valid <= (n - 1) * ps
    q_lat = rng.normal(size=(S, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(S, H, rp)).astype(np.float32)
    args = (_t(q_lat, dtype, dev), _t(q_rope, dtype, dev),
            _t(ckv, dtype, dev), _t(kr, dtype, dev),
            torch.from_numpy(table).to(dev), start, n_valid)
    scale = 192 ** -0.5
    n0 = port_kernel.paged_mla_prefill_kernel.launches
    out = port_ops.paged_mla_prefill(*args, scale=scale, use_kernel=True)
    want = port_ops.paged_mla_prefill(*args, scale=scale, use_kernel=False)
    assert port_kernel.paged_mla_prefill_kernel.launches == n0 + 1
    torch.testing.assert_close(out[:n_valid].float(),
                               want[:n_valid].float(), rtol=0,
                               atol=TOL[dtype])
    assert (out[n_valid:] == 0).all()      # padding rows come back 0


@pytest.mark.cuda
def test_cuda_mla_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    table = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    lengths = torch.ones((2,), dtype=torch.int32, device=dev)

    def call(H, R, rp, ps):
        return port_ops.paged_mla_attention(
            torch.zeros((2, H, R), device=dev),
            torch.zeros((2, H, rp), device=dev),
            torch.zeros((3, ps, R), device=dev),
            torch.zeros((3, ps, rp), device=dev), table, lengths,
            scale=0.1, use_kernel=True)
    with pytest.raises(ValueError, match="MLA geometry"):
        call(8, 512, 64, 16)
    with pytest.raises(ValueError, match="page size"):
        call(16, 512, 64, 4)
    with pytest.raises(ValueError, match="bad chunk bounds"):
        port_ops.paged_mla_prefill(
            torch.zeros((4, 4, 32), device=dev),
            torch.zeros((4, 4, 8), device=dev),
            torch.zeros((3, 16, 32), device=dev),
            torch.zeros((3, 16, 8), device=dev), table[0], 0, 5, scale=0.1,
            use_kernel=True)


def _rel_close(got, want, rtol):
    """max |got - want| within ``rtol`` of the largest |want| (at least 1)."""
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    assert err <= rtol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,chunks,warps", [
    (1, 17, 2560, None, None), (1, 2049, 2560, None, None),
    (2, 100, 129, None, None), (3, 1, 1000, None, None),
    (1, 1, 2560, None, None), (3, 2100, 2560, None, None),
    (1, 2049, 2560, 5, 16), (1, 2049, 2560, 8, 8),
    (1, 2049, 2560, 16, 4), (1, 2049, 2560, 32, 2),
    (1, 2100, 2560, 6, 4), (2, 300, 129, 4, 2),
    (1, 46, 2560, 1, 1), (2, 17, 2500, 1, 1)])
def test_cuda_lru_scan_kernel_matches_plain(B, S, W, chunks, warps):
    """K9 at recurrentgemma's width (W 2560, B 1) and ragged shapes, at the
    split the wrapper picks and at forced ones: 1-16 warps a block, runs
    whose sequence crosses 4-32 super-chunks (S 2100 in 6 of them, and W
    129, the 4-byte staging path, in 4), a batch of 3, one step.  Where
    one warp's run holds the whole sequence, the plain version's result
    bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(S + W)
    la = torch.from_numpy(-np.abs(rng.normal(size=(B, S, W))).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(B, S, W)).astype(np.float32)).to(dev)
    split = lru_kernel.lru_scan_splits(S, chunks=chunks, warps=warps)
    n0 = lru_kernel.lru_scan_kernel.launches
    got = (lru_ops.lru_scan(la, x, use_kernel=True) if chunks is None
           else lru_kernel.lru_scan_kernel(la, x, _splits=split))
    assert lru_kernel.lru_scan_kernel.launches == n0 + 1
    want = lru_scan_ref(la, x)
    if split.steps >= S:
        assert torch.equal(got, want)
    _rel_close(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd", [(1, 17, 32, 64), (1, 46, 32, 64),
                                      (2, 33, 4, 16), (1, 20, 3, 32),
                                      (1, 200, 32, 64), (2, 71, 3, 64)])
def test_cuda_wkv6_kernel_matches_plain(B, S, H, hd):
    """K10 at rwkv6-1.6b's width (H 32, hd 64, B 1), past several 32-step
    staging chunks (S 200, 71), at an odd head count and the smoke shapes,
    s0 != 0: outputs and the final state — the state bit for bit, since
    the kernel rounds its update as the plain version does."""
    dev = _cuda()
    rng = np.random.default_rng(S * hd)

    def t(*shape, decay=False):
        a = rng.normal(size=shape)
        return torch.from_numpy((np.exp(-np.exp(a)) if decay else a).astype(
            np.float32)).to(dev)
    r, k, v = (t(B, S, H, hd) for _ in range(3))
    w = t(B, S, H, hd, decay=True)
    u, s0 = t(H, hd), t(B, H, hd, hd)
    n0 = wkv_kernel.wkv6_kernel.launches
    out, s_last = wkv_ops.wkv6(r, k, v, w, u, s0, use_kernel=True)
    assert wkv_kernel.wkv6_kernel.launches == n0 + 1
    want_out, want_s = wkv_ops.wkv6(r, k, v, w, u, s0, use_kernel=False)
    _rel_close(out, want_out, 1e-4)
    assert torch.equal(s_last, want_s)
    # state threading: two launches equal one
    h = S // 2
    o1, s1 = wkv_ops.wkv6(*(x[:, :h] for x in (r, k, v, w)), u, s0,
                          use_kernel=True)
    o2, s2 = wkv_ops.wkv6(*(x[:, h:] for x in (r, k, v, w)), u, s1,
                          use_kernel=True)
    _rel_close(torch.cat([o1, o2], 1), out, 1e-4)
    _rel_close(s2, s_last, 1e-4)


@pytest.mark.cuda
def test_cuda_recurrence_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    x = torch.zeros((1, 4, 8), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        lru_kernel.lru_scan_kernel(x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="shape mismatch"):
        lru_kernel.lru_scan_kernel(x, x[:, :2].contiguous())
    r = torch.zeros((1, 4, 2, 128), device=dev)
    with pytest.raises(ValueError, match="head size"):
        wkv_kernel.wkv6_kernel(r, r, r, r, torch.zeros((2, 128), device=dev),
                               torch.zeros((1, 2, 128, 128), device=dev))
    r = torch.zeros((1, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="do not fit"):
        wkv_kernel.wkv6_kernel(r, r, r, r, torch.zeros((3, 64), device=dev),
                               torch.zeros((1, 2, 64, 64), device=dev))


# ---------------------------------------------------------------------------
# K4 (ring decode), K5 (ring chunked prefill) and K8 (int8 pages in K1, K2,
# K4, K5)
# ---------------------------------------------------------------------------

def _ring_case(seed, slots, H, KV, hd, ps, n, lengths):
    """A ring of n cells per slot (window n * ps), each slot's cells bound
    up to its length (never past n), the trash page 0 poisoned."""
    rng = np.random.default_rng(seed)
    P = slots * n + 1
    q = rng.normal(size=(slots, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(P, ps, KV, hd)).astype(np.float32)
    table = np.zeros((slots, n), np.int32)
    pid = 1
    for s, length in enumerate(lengths):
        for i in range(min(n, -(-length // ps))):
            table[s, i] = pid
            pid += 1
    k[0], v[0] = 1e4, -1e4
    return q, k, v, table, np.asarray(lengths, np.int32)


def _int8(x, dev):
    """Quantize fp pages the way the pool's writes do: int8 pages and
    bf16 scales."""
    from repro_torch.serving.layouts import quantize_kv
    q, s = quantize_kv(torch.from_numpy(x))
    return q.to(dev), s.to(dev)


#: (slots, H, KV, hd, ps, n, lengths): mixtral's decode (G 6, hd 128, a
#: 4096-token ring of 256 cells) with lengths on both sides of the window
#: and straddling pages of slots shorter than it (where a truncating
#: modulo would unmask never-written cells), and a small hd-64 ring
RING_DECODE_CASES = [
    (8, 48, 8, 128, 16, 256, [1, 17, 4095, 4096, 4097, 4200, 333, 8191]),
    (4, 8, 2, 64, 8, 4, [3, 9, 32, 77]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RING_DECODE_CASES)
def test_cuda_ring_decode_kernel_matches_plain(case, dtype, int8):
    dev = _cuda()
    slots, H, KV, hd, ps, n, lengths = case
    q, k, v, table, lens = _ring_case(6, slots, H, KV, hd, ps, n, lengths)
    if int8:
        (kp, ks), (vp, vs) = _int8(k, dev), _int8(v, dev)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, kw = _t(k, dtype, dev), _t(v, dtype, dev), {}
    args = (_t(q, dtype, dev), kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(lens).to(dev))
    n0 = port_kernel.paged_attention_kernel.launches
    out = port_ops.paged_attention(*args, window=n * ps, use_kernel=True,
                                   **kw)
    want = port_ops.paged_attention(*args, window=n * ps, use_kernel=False,
                                    **kw)
    assert port_kernel.paged_attention_kernel.launches == n0 + 1
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_decode_and_prefill_kernels_match_plain(dtype):
    """K8 in K1 and K2 at qwen's serving geometry (G 5, hd 128)."""
    dev = _cuda()
    q, k, v, table, lengths = _decode_case(8, 8, 40, 8, 128, 16, 6)
    (kp, ks), (vp, vs) = _int8(k, dev), _int8(v, dev)
    args = (_t(q, dtype, dev), kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths).to(dev))
    out = port_ops.paged_attention(*args, k_scale=ks, v_scale=vs,
                                   use_kernel=True)
    want = port_ops.paged_attention(*args, k_scale=ks, v_scale=vs,
                                    use_kernel=False)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    rng = np.random.default_rng(9)
    row = torch.from_numpy(table[3]).to(dev)
    for S, start, n_valid in ((5, 90, 3), (64, 0, 60)):
        qp = _t(rng.normal(size=(S, 40, 128)).astype(np.float32), dtype, dev)
        n0 = port_kernel.paged_prefill_kernel.launches
        out = port_ops.paged_prefill(qp, kp, vp, row, start, n_valid,
                                     k_scale=ks, v_scale=vs, use_kernel=True)
        want = port_ops.paged_prefill(qp, kp, vp, row, start, n_valid,
                                      k_scale=ks, v_scale=vs,
                                      use_kernel=False)
        assert port_kernel.paged_prefill_kernel.launches == n0 + 1
        torch.testing.assert_close(out[:n_valid].float(),
                                   want[:n_valid].float(), rtol=0,
                                   atol=TOL[dtype])


#: (H, KV, hd, ps, n, S, start, n_valid): window = n * ps.  The JAX test
#: grid's cases (cold, wrapped, partial, S > window), a verify row, and
#: mixtral's chunks: 1024 queries wrapping the 4096-token ring, a ragged
#: fifth chunk of a 4,200-token prompt, a verify row past the window
RING_PREFILL_CASES = [
    (4, 2, 64, 8, 3, 16, 0, 16),
    (4, 2, 64, 8, 3, 16, 30, 13),
    (8, 8, 64, 4, 4, 8, 10, 5),
    (2, 1, 64, 8, 2, 32, 70, 27),
    (48, 8, 128, 16, 256, 1024, 3584, 1024),
    (48, 8, 128, 16, 256, 128, 4096, 104),
    (48, 8, 128, 16, 256, 5, 4210, 2),
    # G = 6 with S * G not a multiple of the 64-row tile (rows straddle
    # tiles and queries), at hd 128 and 64
    (48, 8, 128, 16, 256, 37, 3000, 37),
    (12, 2, 64, 8, 4, 21, 40, 19),
]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RING_PREFILL_CASES)
def test_cuda_ring_prefill_kernel_matches_plain(case, dtype, int8):
    dev = _cuda()
    H, KV, hd, ps, n, S, start, n_valid = case
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(S, H, hd)).astype(np.float32), dtype, dev)
    k = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    ck = _t(rng.normal(size=(S, KV, hd)).astype(np.float32), dtype, dev)
    cv = _t(rng.normal(size=(S, KV, hd)).astype(np.float32), dtype, dev)
    row = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    if int8:
        (kp, ks), (vp, vs) = _int8(k, dev), _int8(v, dev)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, kw = _t(k, dtype, dev), _t(v, dtype, dev), {}
    args = (q, kp, vp, ck, cv, row, start, n_valid)
    n0 = port_kernel.paged_ring_prefill_kernel.launches
    out = port_ops.paged_ring_prefill(*args, window=n * ps, use_kernel=True,
                                      **kw)
    want = port_ops.paged_ring_prefill(*args, window=n * ps,
                                       use_kernel=False, **kw)
    assert port_kernel.paged_ring_prefill_kernel.launches == n0 + 1
    torch.testing.assert_close(out[:n_valid].float(),
                               want[:n_valid].float(), rtol=0,
                               atol=TOL[dtype])
    assert (out[n_valid:] == 0).all()      # padding rows come back 0


@pytest.mark.cuda
def test_cuda_ring_and_int8_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    q = torch.zeros((2, 4, 64), device=dev)
    pages = torch.zeros((3, 4, 2, 64), dtype=torch.int8, device=dev)
    scale = torch.zeros((3, 4, 2), dtype=torch.bfloat16, device=dev)
    table = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    lengths = torch.ones((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        port_ops.paged_attention(q, pages, pages, table, lengths,
                                 k_scale=scale, use_kernel=True)
    with pytest.raises(ValueError, match="bfloat16"):
        port_ops.paged_attention(q, pages, pages, table, lengths,
                                 k_scale=scale.float(), v_scale=scale.float(),
                                 use_kernel=True)
    fp = torch.zeros((3, 4, 2, 64), device=dev)
    chunk = torch.zeros((5, 2, 64), device=dev)
    with pytest.raises(ValueError, match="window"):
        port_ops.paged_ring_prefill(torch.zeros((5, 4, 64), device=dev), fp,
                                    fp, chunk, chunk, table[0].repeat(3), 0,
                                    5, window=8, use_kernel=True)
    with pytest.raises(ValueError, match="head_dim"):
        port_ops.paged_ring_prefill(
            torch.zeros((5, 4, 256), device=dev),
            torch.zeros((3, 4, 2, 256), device=dev),
            torch.zeros((3, 4, 2, 256), device=dev),
            torch.zeros((5, 2, 256), device=dev),
            torch.zeros((5, 2, 256), device=dev), table[0], 0, 5, window=8,
            use_kernel=True)


def _ring_prefill_args(case, dtype, int8, dev, seed=7):
    H, KV, hd, ps, n, S, start, n_valid = case
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(S, H, hd)).astype(np.float32), dtype, dev)
    k = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(n + 1, ps, KV, hd)).astype(np.float32)
    ck = _t(rng.normal(size=(S, KV, hd)).astype(np.float32), dtype, dev)
    cv = _t(rng.normal(size=(S, KV, hd)).astype(np.float32), dtype, dev)
    row = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    if int8:
        (kp, ks), (vp, vs) = _int8(k, dev), _int8(v, dev)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, kw = _t(k, dtype, dev), _t(v, dtype, dev), {}
    return (q, kp, vp, ck, cv, row, start, n_valid), dict(kw, window=n * ps)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_cuda_ring_verify_rows_take_the_split_path(S, int8):
    """Verify rows (S = spec_tokens + 1 <= 5) past mixtral's window: 8
    blocks on the card, so the bf16 kernel splits their key tiles and
    merges the partials."""
    dev = _cuda()
    case = (48, 8, 128, 16, 256, S, 4210, S)
    args, kw = _ring_prefill_args(case, "bfloat16", int8, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert port_kernel.prefill_splits(S, 6, 8, 4210, S, sms, 4096) > 1
    n0 = port_kernel.paged_ring_prefill_kernel.launches
    out = port_ops.paged_ring_prefill(*args, use_kernel=True, **kw)
    want = port_ops.paged_ring_prefill(*args, use_kernel=False, **kw)
    assert port_kernel.paged_ring_prefill_kernel.launches == n0 + 1
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL["bfloat16"])


#: (case as RING_PREFILL_CASES, forced splits): a verify row; a chunk of
#: 64 single-head rows against a 16-token window, whose 2 key tiles leave
#: its first rows no live key in the second split and, at 4 splits, two
#: splits with no tile at all; a ragged G = 6 chunk
SPLIT_CASES = [((48, 8, 128, 16, 256, 5, 4210, 5), 33),
               ((1, 1, 64, 8, 2, 64, 100, 64), 2),
               ((1, 1, 64, 8, 2, 64, 100, 64), 4),
               ((12, 2, 64, 8, 4, 21, 40, 19), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case,splits", SPLIT_CASES)
def test_cuda_ring_prefill_split_matches_unsplit(case, splits, int8):
    """The split launch (partials + merge) against the unsplit one and the
    plain version, through the wrapper's internal split count."""
    dev = _cuda()
    args, kw = _ring_prefill_args(case, "bfloat16", int8, dev, seed=11)
    n_valid = args[7]
    whole = port_kernel.paged_ring_prefill_kernel
    q4 = args[0].reshape(args[0].shape[0], args[1].shape[2], -1,
                         args[0].shape[-1]).contiguous()
    got = whole(q4, *args[1:], _splits=splits, **kw)
    one = whole(q4, *args[1:], _splits=1, **kw)
    want = port_ops.paged_ring_prefill(*args, use_kernel=False, **kw)
    torch.testing.assert_close(got[:n_valid].float(), one[:n_valid].float(),
                               rtol=0, atol=TOL["bfloat16"])
    torch.testing.assert_close(
        got[:n_valid].float().reshape(want[:n_valid].shape),
        want[:n_valid].float(), rtol=0, atol=TOL["bfloat16"])
    assert (got[n_valid:] == 0).all()


# ---------------------------------------------------------------------------
# K1 / K4 and their K8 branches split over pages
# ---------------------------------------------------------------------------

#: (slots, H, KV, hd, ps, n, window, lengths): qwen's decode (G 5, a table
#: of 16 pages; window 0 = contiguous pages), mixtral's 4096-token ring (G
#: 6), a small hd-64 ring, and groups past a block's 8 heads (G 12: a full
#: and a partial G-group; G 32 on one kv-head), lengths 0 and 1 among
#: them, the trash page 0 poisoned
DECODE_SPLIT_CASES = [
    (8, 40, 8, 128, 16, 16, 0, [0, 1, 16, 17, 256, 100, 37, 200]),
    (8, 48, 8, 128, 16, 256, 4096, [0, 1, 17, 4095, 4096, 4097, 333, 8191]),
    (4, 8, 2, 64, 8, 4, 32, [0, 1, 9, 77]),
    (4, 48, 4, 128, 16, 8, 0, [0, 1, 77, 128]),
    (2, 32, 1, 64, 8, 4, 32, [5, 40]),
]


def _decode_split_args(case, dtype, int8, dev):
    slots, H, KV, hd, ps, n, window, lengths = case
    q, k, v, table, lens = _ring_case(12, slots, H, KV, hd, ps, n, lengths)
    if int8:
        (kp, ks), (vp, vs) = _int8(k, dev), _int8(v, dev)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, kw = _t(k, dtype, dev), _t(v, dtype, dev), {}
    args = (_t(q, dtype, dev), kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(lens).to(dev))
    return args, dict(kw, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["2", "cap"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_SPLIT_CASES)
def test_cuda_decode_split_matches_unsplit(case, dtype, int8, which):
    """The split launch (partials merged by the last split's block) against
    the unsplit one and the plain version, through the wrapper's internal
    split count: 2, and the shape's cap (the table's pages where the cap is
    below 3, so short slots leave splits empty)."""
    dev = _cuda()
    slots, H, KV, hd, ps, n, window, lengths = case
    args, kw = _decode_split_args(case, dtype, int8, dev)
    cap = port_kernel.decode_split_cap(n, ps, window)
    splits = 2 if which == "2" else (cap if cap > 2 else n)
    q4 = args[0].reshape(slots, KV, H // KV, hd)
    whole = port_kernel.paged_attention_kernel
    n0 = whole.launches
    got = whole(q4, *args[1:], _splits=splits, **kw).reshape(args[0].shape)
    one = whole(q4, *args[1:], _splits=1, **kw).reshape(args[0].shape)
    assert whole.launches == n0 + 2
    want = port_ops.paged_attention(*args, use_kernel=False, **kw)
    live = args[4] > 0
    for out in (got, one):
        torch.testing.assert_close(out[live].float(), want[live].float(),
                                   rtol=0, atol=TOL[dtype])
        assert (out[~live] == 0).all()          # length 0 comes out 0
    torch.testing.assert_close(got.float(), one.float(), rtol=0,
                               atol=TOL[dtype])
    # the counters are left zero: the same launch again gives the same out
    again = whole(q4, *args[1:], _splits=splits, **kw).reshape(got.shape)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_decode_split_count_does_not_sync_the_host():
    """Choosing the split count reads shapes only: the wrapper runs under
    ``set_sync_debug_mode("error")``, which raises on any host sync."""
    dev = _cuda()
    case = DECODE_SPLIT_CASES[1]
    args, kw = _decode_split_args(case, "bfloat16", False, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert port_kernel.decode_splits(8, 8, 256, 16, 4096, sms) > 1
    port_ops.paged_attention(*args, use_kernel=True, **kw)   # built, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = port_ops.paged_attention(*args, use_kernel=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = port_ops.paged_attention(*args, use_kernel=False, **kw)
    live = args[4] > 0
    torch.testing.assert_close(out[live].float(), want[live].float(),
                               rtol=0, atol=TOL["bfloat16"])


# ---------------------------------------------------------------------------
# K2 (and its K8 branch) on the tensor cores, split over key tiles; K6 split
# over pages
# ---------------------------------------------------------------------------

#: (S, start, n_valid) of qwen's verify rows and prefill buckets (the
#: kernel phase's K2_CASES in chip_smoke.py) and a verify after a
#: 480-token prefix, whose 8 key tiles take the split path
K2_CASES = [(5, 0, 5), (5, 37, 3), (16, 0, 11), (16, 32, 16), (64, 0, 40),
            (64, 64, 64), (256, 0, 200), (256, 48, 256), (5, 480, 5)]


def _k2_args(S, start, n_valid, dtype, int8, dev, KV=8, G=5, hd=128, ps=16,
             n=32, seed=13):
    """qwen's prefill geometry on a 32-page table of distinct random pages,
    the trash page 0 (poisoned) after the chunk's last page."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, KV * G, hd)).astype(np.float32)
    k = rng.normal(size=(n + 8, ps, KV, hd)).astype(np.float32)
    v = rng.normal(size=(n + 8, ps, KV, hd)).astype(np.float32)
    k[0], v[0] = 1e4, -1e4
    table = np.zeros(n, np.int32)
    held = -(-(start + n_valid) // ps)
    table[:held] = rng.permutation(n + 7)[:held] + 1
    if int8:
        (kp, ks), (vp, vs) = _int8(k, dev), _int8(v, dev)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, kw = _t(k, dtype, dev), _t(v, dtype, dev), {}
    return (_t(q, dtype, dev), kp, vp, torch.from_numpy(table).to(dev),
            start, n_valid), kw


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K2_CASES)
def test_cuda_prefill_kernel_at_serving_cases(case, dtype, int8):
    """K2 (and int8 pages, K8) at every serving shape against its plain
    version; padding rows come back 0."""
    dev = _cuda()
    args, kw = _k2_args(*case, dtype, int8, dev)
    n_valid = case[2]
    n0 = port_kernel.paged_prefill_kernel.launches
    out = port_ops.paged_prefill(*args, use_kernel=True, **kw)
    want = port_ops.paged_prefill(*args, use_kernel=False, **kw)
    assert port_kernel.paged_prefill_kernel.launches == n0 + 1
    torch.testing.assert_close(out[:n_valid].float(),
                               want[:n_valid].float(), rtol=0,
                               atol=TOL[dtype])
    assert (out[n_valid:] == 0).all()


#: (S, start, n_valid, KV, G, hd, ps, forced splits): the long-prefix
#: verify at 8 splits (its own count) and 3, a 64-query bucket whose first
#: row tile has 2 key tiles, and an hd-64, G-8 chunk
PREFILL_SPLIT_CASES = [(5, 480, 5, 8, 5, 128, 16, 8),
                       (5, 480, 5, 8, 5, 128, 16, 3),
                       (64, 64, 64, 8, 5, 128, 16, 2),
                       (21, 40, 19, 2, 8, 64, 8, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", PREFILL_SPLIT_CASES)
def test_cuda_prefill_split_matches_unsplit(case, int8):
    """The split launch (partials + merge) against the unsplit one and the
    plain version, through the wrapper's internal split count."""
    dev = _cuda()
    S, start, n_valid, KV, G, hd, ps, splits = case
    args, kw = _k2_args(S, start, n_valid, "bfloat16", int8, dev, KV=KV, G=G,
                        hd=hd, ps=ps, seed=17)
    q4 = args[0].reshape(S, KV, G, hd)
    whole = port_kernel.paged_prefill_kernel
    got = whole(q4, *args[1:], _splits=splits, **kw).reshape(args[0].shape)
    one = whole(q4, *args[1:], _splits=1, **kw).reshape(args[0].shape)
    want = port_ops.paged_prefill(*args, use_kernel=False, **kw)
    for out in (got, one):
        torch.testing.assert_close(out[:n_valid].float(),
                                   want[:n_valid].float(), rtol=0,
                                   atol=TOL["bfloat16"])
        assert (out[n_valid:] == 0).all()
    torch.testing.assert_close(got[:n_valid].float(), one[:n_valid].float(),
                               rtol=0, atol=TOL["bfloat16"])


def _mla_split_args(H, R, rp, ps, n, dtype, dev, seed=19):
    """Eight slots of lengths 0, 1, ps, ps + 1 and a full table among
    them, distinct pages from 1 up, the trash page 0 poisoned."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([0, 1, ps, ps + 1, n * ps, 3 * ps - 5, 2 * ps,
                          n * ps - 1], np.int32)
    table = np.zeros((8, n), np.int32)
    pid = 1
    for s, length in enumerate(lengths):
        for i in range(-(-int(length) // ps)):
            table[s, i] = pid
            pid += 1
    ckv, kr = _mla_pages(rng, 8 * n + 1, ps, R, rp)
    q_lat = rng.normal(size=(8, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(8, H, rp)).astype(np.float32)
    return (_t(q_lat, dtype, dev), _t(q_rope, dtype, dev),
            _t(ckv, dtype, dev), _t(kr, dtype, dev),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["2", "cap"])
@pytest.mark.parametrize("H,R,rp", MLA_GEOMS)
@pytest.mark.parametrize("ps", [16, 64])
def test_cuda_mla_decode_split_matches_unsplit(H, R, rp, ps, which):
    """The bf16 K6 split launch (partials merged by the last split's block)
    against the unsplit one and the plain version: 2 splits, and as many as
    the table has pages (short slots leave splits empty)."""
    dev = _cuda()
    n = 6
    args = _mla_split_args(H, R, rp, ps, n, "bfloat16", dev)
    splits = 2 if which == "2" else n
    scale = 192 ** -0.5
    whole = port_kernel.paged_mla_kernel
    n0 = whole.launches
    got = whole(*args, scale=scale, _splits=splits)
    one = whole(*args, scale=scale, _splits=1)
    assert whole.launches == n0 + 2
    want = port_ops.paged_mla_attention(*args, scale=scale, use_kernel=False)
    live = args[5] > 0
    for out in (got, one):
        torch.testing.assert_close(out[live].float(), want[live].float(),
                                   rtol=0, atol=TOL["bfloat16"])
        assert (out[~live] == 0).all()          # length 0 comes out 0
    torch.testing.assert_close(got.float(), one.float(), rtol=0,
                               atol=TOL["bfloat16"])
    # the counters are left zero: the same launch again gives the same out
    again = whole(*args, scale=scale, _splits=splits)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_prefill_and_mla_split_counts_do_not_sync_the_host():
    """K2's and K6's split counts read shapes (and K2's host-side chunk
    bounds) only: the wrappers run under ``set_sync_debug_mode("error")``,
    which raises on any host sync."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert port_kernel.prefill_splits(5, 5, 8, 480, 5, sms) > 1
    assert port_kernel.mla_decode_splits(8, 8, sms) > 1
    k2_args, kw = _k2_args(5, 480, 5, "bfloat16", False, dev)
    mla = _mla_split_args(16, 512, 64, 16, 8, "bfloat16", dev)
    scale = 192 ** -0.5

    def both():
        return (port_ops.paged_prefill(*k2_args, use_kernel=True, **kw),
                port_ops.paged_mla_attention(*mla, scale=scale,
                                             use_kernel=True))
    both()                                      # built, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, out_mla = both()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = port_ops.paged_prefill(*k2_args, use_kernel=False, **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL["bfloat16"])
    want = port_ops.paged_mla_attention(*mla, scale=scale, use_kernel=False)
    live = mla[5] > 0
    torch.testing.assert_close(out_mla[live].float(), want[live].float(),
                               rtol=0, atol=TOL["bfloat16"])


# ---------------------------------------------------------------------------
# K7 split over key tiles (bf16)
# ---------------------------------------------------------------------------

def _mla_prefill_args(H, R, rp, S, start, n_valid, dtype, dev, seed=23):
    """One chunk against a 16-cell-page table whose pages are distinct and
    random, the trash page 0 poisoned and named by the table's tail."""
    rng = np.random.default_rng(seed)
    ps = 16
    n = -(-(start + n_valid) // ps) + 1
    ckv, kr = _mla_pages(rng, n + 4, ps, R, rp)
    table = np.zeros(n, np.int32)
    table[:n - 1] = rng.permutation(n + 3)[:n - 1] + 1
    q_lat = rng.normal(size=(S, H, R)).astype(np.float32)
    q_rope = rng.normal(size=(S, H, rp)).astype(np.float32)
    return (_t(q_lat, dtype, dev), _t(q_rope, dtype, dev),
            _t(ckv, dtype, dev), _t(kr, dtype, dev),
            torch.from_numpy(table).to(dev), start, n_valid)


#: (S, start, n_valid): the verify after a 100-token prefix (4 key tiles a
#: query block), a ragged verify, a bucket with a padded tail and a
#: partial last query block
MLA_PREFILL_SPLIT_CASES = [(5, 100, 5), (5, 37, 3), (16, 32, 14),
                           (7, 200, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("H,R,rp", MLA_GEOMS)
@pytest.mark.parametrize("case", MLA_PREFILL_SPLIT_CASES)
def test_cuda_mla_prefill_split_matches_unsplit(case, H, R, rp, splits):
    """The bf16 K7 launch at forced split counts (the splits of a query
    block merged over the cluster's shared memory; 8 splits of 2-7 key
    tiles leave splits empty) against the unsplit launch and the plain
    version; padding rows come back 0."""
    dev = _cuda()
    args = _mla_prefill_args(H, R, rp, *case, "bfloat16", dev)
    scale = 192 ** -0.5
    whole = port_kernel.paged_mla_prefill_kernel
    n0 = whole.launches
    got = whole(*args, scale=scale, _splits=splits)
    one = whole(*args, scale=scale, _splits=1)
    assert whole.launches == n0 + 2
    want = port_ops.paged_mla_prefill(*args, scale=scale, use_kernel=False)
    n_valid = case[2]
    for out in (got, one):
        torch.testing.assert_close(out[:n_valid].float(),
                                   want[:n_valid].float(), rtol=0,
                                   atol=TOL["bfloat16"])
        assert (out[n_valid:] == 0).all()
    torch.testing.assert_close(got.float(), one.float(), rtol=0,
                               atol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_prefill_long_verify_takes_the_split_path(dtype):
    """The long-prefix verify through the public entry point: bf16 splits
    (``mla_prefill_splits`` > 1, read from shapes only: the call runs under
    ``set_sync_debug_mode("error")``), fp32 runs the scalar body; both
    within their tolerance of the plain version."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert port_kernel.mla_prefill_splits(5, 100, 5, sms) > 1
    args = _mla_prefill_args(16, 512, 64, 5, 100, 5, dtype, dev)
    scale = 192 ** -0.5
    port_ops.paged_mla_prefill(*args, scale=scale, use_kernel=True)
    torch.cuda.synchronize()                    # built, warm
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = port_ops.paged_mla_prefill(*args, scale=scale, use_kernel=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = port_ops.paged_mla_prefill(*args, scale=scale, use_kernel=False)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_mla_prefill_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    args = _mla_prefill_args(4, 32, 8, 5, 37, 3, "float32", dev)
    with pytest.raises(ValueError, match="only the bf16 kernel splits"):
        port_kernel.paged_mla_prefill_kernel(*args, scale=0.1, _splits=2)
    bf = tuple(a.bfloat16() if torch.is_tensor(a) and a.is_floating_point()
               else a for a in args)
    with pytest.raises(ValueError, match="splits 9 outside"):
        port_kernel.paged_mla_prefill_kernel(*bf, scale=0.1, _splits=9)
    with pytest.raises(ValueError, match="past the table"):
        port_kernel.paged_mla_prefill_kernel(*bf[:5], 60, 5, scale=0.1)


# ---------------------------------------------------------------------------
# Training: forward-only kernels stay off the autograd path; AlexNet's step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_forward_only_kernels_raise_on_inputs_that_require_grad():
    """K9, K10 and the raw K3 fill ``torch.empty`` outputs (no
    ``grad_fn``): on inputs that require grad under grad mode they raise
    instead of cutting the graph; under ``no_grad`` they run.  K3 under
    grad goes through the autograd Function, whose gradients flow."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    la, x = -torch.rand((1, 17, 64), generator=g, device=dev), rnd(1, 17, 64)
    r, k, v = rnd(1, 9, 2, 16), rnd(1, 9, 2, 16), rnd(1, 9, 2, 16)
    w, u, s0 = torch.rand((1, 9, 2, 16), generator=g, device=dev), \
        rnd(2, 16), rnd(1, 2, 16, 16)
    q3, k3 = rnd(2, 64, 64), rnd(2, 64, 64)
    calls = {
        "K9": lambda a, b: lru_kernel.lru_scan_kernel(a, b),
        "K10": lambda a, b: wkv_kernel.wkv6_kernel(a, k, v, w, u, b),
        "K3": lambda a, b: flash_kernel.flash_attention_kernel(a, b, b),
    }
    args = {"K9": (la, x), "K10": (r, s0), "K3": (q3, k3)}
    for name, fn in calls.items():
        a, b = args[name]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(a.clone().requires_grad_(), b)
        with torch.no_grad():
            fn(a.clone().requires_grad_(), b)
        fn(a, b)                       # nothing requires grad: runs
    q = rnd(1, 64, 2, 64).requires_grad_()
    kk, vv = rnd(1, 64, 2, 64), rnd(1, 64, 2, 64)
    before = flash_kernel.flash_attention_kernel.launches
    out = flash_attention_vjp(q, kk, vv, causal=True, use_kernel=True)
    (gq,) = torch.autograd.grad(out.square().sum(), q)
    assert flash_kernel.flash_attention_kernel.launches == before + 1
    assert float(gq.abs().max()) > 0


@pytest.mark.cuda
def test_cuda_alexnet_step_matches_cpu_autograd():
    """One momentum (lr 1e-2) step of full-size AlexNet (227 x 227, 1000
    classes) at batch 2 through ``TransparentTrainer`` on the card against
    the same step on the CPU, from the same weights, TF32 off: the loss
    within rel 1e-4, every gradient leaf within 1e-3 of its largest
    |grad| (cuDNN's and the CPU's convolutions sum fp32 terms in other
    orders), every updated weight within lr x that (1e-5 of the leaf's
    largest |grad|: the reference's fan-in init on N(0, 1) images gives
    logits near 1e3 and weight gradients up to ~1e4)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.core.transparent import TransparentTrainer, \
        _value_and_grad
    from repro_torch.models import cnn
    from repro_torch.models.common import init_params, tree_leaves
    dev = _cuda()
    specs = cnn.alexnet_specs()
    params = init_params(specs, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    rng = np.random.default_rng(5)
    batch = {"images": torch.from_numpy(rng.normal(
        size=(2, 227, 227, 3)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 1000, (2,)))}
    loss_fn = lambda p, b: cnn.cnn_loss(cnn.alexnet_forward, p, b, 1000)
    run = RunConfig(model=get_config("alexnet"),
                    shape=ShapeConfig("t", "train", 227, 2),
                    mesh=MeshConfig(shape=(1, 1), axis_names=("data", "model")),
                    optimizer=OptimizerConfig(name="momentum", lr=1e-2))
    out = {}
    for d in ("cpu", dev):
        tr = TransparentTrainer(run, loss_fn, specs, device=d)
        state = tr.init(params=params)
        b = {k: t.to(d) for k, t in batch.items()}
        loss, grads = _value_and_grad(loss_fn, state.params, b)
        state, m = tr.step(state, b)
        out[str(d)] = (float(loss), float(m["loss"]),
                       [t.cpu() for t in tree_leaves(grads)],
                       [t.cpu() for t in tree_leaves(state.params)])
    (cl, cm, cg, cp), (gl, gm, gg, gp) = out["cpu"], out[str(dev)]
    assert abs(gl - cl) <= 1e-4 * abs(cl) and abs(gm - cm) <= 1e-4 * abs(cm)
    for a, b, p, q in zip(gg, cg, gp, cp):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 1e-3 * scale
        assert float((p - q).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# K11: the MoE sorted route's grouped GEMM
# ---------------------------------------------------------------------------

def _moe_case(dev, seed, N, n_valid, E, K, D, F, dtype):
    """x [N, D], expert weights scaled to keep h and the rows O(1), every
    token's K distinct experts at random, padding past ``n_valid`` routed
    nowhere (expert E), gates renormalised."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    x = rnd(N, D)
    w = (rnd(E, D, F, scale=D ** -0.5), rnd(E, D, F, scale=D ** -0.5),
         rnd(E, F, D, scale=F ** -0.5))
    sel = torch.rand((N, E), generator=g, device=dev).argsort(1)[:, :K]
    sel[n_valid:] = E
    gates = torch.rand((N, K), generator=g, device=dev) + 0.1
    return x, w, sel.reshape(-1), gates / gates.sum(1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,n_valid,E,K,D,F", [
    (5, 5, 64, 6, 2048, 1408), (512, 512, 64, 6, 2048, 1408),
    (512, 300, 64, 6, 2048, 1408), (512, 512, 8, 2, 6144, 16384),
    (37, 30, 8, 2, 136, 200)],
    ids=["dsv2-verify", "dsv2-chunk", "dsv2-bucket", "mixtral-chunk",
         "ragged"])
def test_cuda_moe_grouped_kernel_matches_plain(dtype, N, n_valid, E, K, D, F):
    """K11 at deepseek-v2-lite's width (a verify row of 5, a 512-token
    chunk, a bucket with 300 valid of 512), at mixtral-8x22b's (bf16 only:
    its fp32 weights and the plain version's per-tile copies would take
    ~30 GB) and at a ragged width, against its plain version over the same
    tile table.  Tolerance, max |err| over max(1, max |plain|): bf16 2^-6
    (both round h and each expert's output at the same points; a last-bit
    difference of their fp32 sums flips a rounding by one bf16 ulp, 2^-8
    relative), fp32 1e-4 (the same products summed in another order)."""
    if dtype == "float32" and E == 8 and D == 6144:
        pytest.skip("mixtral's width runs in bf16 only (memory)")
    from repro_torch.kernels.moe_grouped import kernel as mk
    from repro_torch.kernels.moe_grouped import ref
    dev = _cuda()
    x, (wg, wu, wd), flat_e, gates = _moe_case(dev, N + E, N, n_valid, E, K,
                                               D, F, TORCH[dtype])
    n0 = mk.moe_grouped.launches
    got = mk.moe_grouped(x, wg, wu, wd, flat_e, gates, first=0, act="silu")
    assert mk.moe_grouped.launches == n0 + 3
    order, tiles = ref.group_picks(flat_e, 0, E)
    inv = torch.empty_like(order).scatter_(0, order,
                                           torch.arange(N * K, device=dev))
    want = ref.moe_grouped_ref(x, wg, wu, wd, order // K,
                               gates.to(x.dtype).reshape(-1)[order], tiles,
                               flat_e.view(N, K), inv.view(N, K), first=0,
                               act="silu")
    assert torch.equal(got[n_valid:], torch.zeros_like(got[n_valid:]))
    _rel_close(got, want, 2.0 ** -6 if dtype == "bfloat16" else 1e-4)


@pytest.mark.cuda
def test_cuda_moe_sorted_route_never_syncs_and_launches_k11():
    """``moe_apply(per_token=True)`` at deepseek-v2-lite's full width (one
    layer's experts, a bucket with 300 valid of 512) under
    ``set_sync_debug_mode("error")``: no host read anywhere in the layer,
    and the route ran through K11 (its launch count rose by 3)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_grouped import kernel as mk
    from repro_torch.models import moe
    dev = _cuda()
    cfg = get_config("deepseek-v2-lite-16b")
    m, D = cfg.moe, cfg.d_model
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev)
                * shape[-2] ** -0.5).to(torch.bfloat16)
    E, F = m.num_experts, m.d_ff_expert
    fs = m.d_ff_shared or F * m.num_shared_experts
    p = {"router": rnd(D, E), "w_gate": rnd(E, D, F), "w_up": rnd(E, D, F),
         "w_down": rnd(E, F, D),
         "shared": {"w_gate": rnd(D, fs), "w_up": rnd(D, fs),
                    "w_down": rnd(fs, D)}}
    x = torch.randn((1, 512, D), generator=g, device=dev).to(torch.bfloat16)
    n0 = mk.moe_grouped.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe.moe_apply(cfg, p, x, n_valid=300, per_token=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert mk.moe_grouped.launches == n0 + 3
    assert y.shape == x.shape and bool(torch.isfinite(y[:, :300]).all())
