#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment — torch / CUDA versions and the card's name and power limit;
2. build — every CUDA source under ``src/repro_torch/csrc`` with ``nvcc``,
   one process per source, all started together; each kernel's registers
   and spills (``-Xptxas -v``); then ``cuobjdump -sass`` of the K3, K2,
   K5, K1 / K4, K6 and K7 libraries: every bf16 instantiation of their
   tensor-core kernels must issue HGMMA (wgmma; K3, K2, K5) or HMMA
   (mma.sync; K1 / K4, K6, K7) instructions;
3. kernels — each hand-written kernel held against its plain PyTorch
   version on the card at its path's shapes (K1, K2: qwen serving; K3: the
   training forward, plus a sliding-window and a ragged case, the flash
   autograd Function's gradients against autograd through the plain
   version, and recurrentgemma's local attention at hd 256; K6, K7:
   deepseek serving, absorbed MLA on latent pages; K9: the RG-LRU scan at
   recurrentgemma's width, also at forced splits (1-8 warps a block, 16
   super-chunks), bit for bit where one warp's run holds the sequence,
   with forced-split sweeps at S 2049 and 46; K10: the RWKV-6 WKV
   recurrence at rwkv6's, with s0 != 0; K4 / K5: mixtral's ring decode,
   lengths on both sides of its 4096-token window, and ring chunked
   prefill, a 1024-query chunk that wraps the ring and a verify row (the
   bf16 kernel's split path), both reported; K8: int8 pages in K1, K2 at
   qwen's shapes and K4, K5 at mixtral's; in bf16, and checked in fp32 —
   K1 / K4 / K8 within 1e-5 there; K7 also at forced split counts, with a
   forced-split sweep of its long verify), with its time beside the plain
   version's (K1 / K4 / K8 also with their split count, CUDA launches a
   call and registers and spills; K1, K2, K4, K6, K7, K9, K10 and the K8
   branches also with their device time alone, ``device_ms``, beside the
   library call's where there is one), a bytes/operations bound, and,
   where one exists, one PyTorch library call computing the same function
   as a yardstick (timed here only; the port never calls it);
4. serve — full-width ``qwen2.5-14b`` (random weights from a seed) served
   through ``repro_torch.api.load(...).serve`` with the kernels on: a
   shared page-aligned prefix (prefix-cache hit) and a repetitive prompt
   (n-gram drafts verified through the prefill kernel).  Every decode
   cycle is one CUDA-graph replay (``ServeConfig.decode_graphs``, which
   each drive prints as its engine resolved it, with its decode cycles
   and the decode steps the card ran).  Every kernel's launch count is
   zeroed just before and read just after; each must be launched, the
   decode kernel (K1; K4, K6 and the K8 branches on their drives) layers
   x decode steps times (a replay counts its graph's captured launches)
   and the prefill kernel layers x (chunks + verifies); then the same
   drive with every K1 / K2 launch held against its plain version on that
   launch's inputs — the eager arm (``decode_graphs=False``: the checks
   wrap Python functions), whose streams must equal the graphed drive's
   token for token; qwen's decode graphs (count, warm-up and capture
   seconds, private pool bytes) and a warm profile of both arms (busy
   share, the host's CUDA kernel / graph launch calls per decode cycle,
   tok/s);
5. comparison — the same requests with ``use_kernels=False`` (plain
   versions on the card); greedy streams must match, or part only where
   the plain forward's top two logits are a bf16 near-tie; then the same
   requests on the slotted pool (``kv_layout="slotted"``: bucketed
   whole-prompt prefill through K3, batched slot decode), whose partings
   from the paged arm are printed;
6. train — full-width ``qwen2.5-14b`` cut to 4 layers, trained through
   ``repro_torch.api.load(...).train`` on one seeded global batch (2 x 2048
   tokens, repeated, so the loss must fall), in a one-rank NCCL process
   group with the ``bucketed`` all-reduce: ``train(1)`` then ``train(5)``
   (the stream continues, so this is ``train(6)``; the second call's time
   is the steady step time).  K3's count is zeroed before and must equal
   steps x layers x (2 under remat, which runs each layer's forward
   again in the backward); one more step runs under the profiler for K3's
   share of device time.  Then the plain arm (``use_kernels=False``) from
   the same init: step-1 loss and grad norm agree, and its loss falls too.
   In the same process group: checkpoint / resume on ``recurrentgemma-2b``
   cut to one super-block (an uninterrupted ``train(6)``; ``train(3, ckpt_dir,
   ckpt_every=3)``; a new Session's ``train(3, ckpt_dir, resume=True)``
   equals its steps 4-6 within rel 1e-5; save sizes and times printed);
   the paper's AlexNet at full size (227 x 227 x 3, 1000 classes, 62.4 M
   parameters, fp32, TF32 off and printed) through ``TransparentTrainer``,
   6 momentum steps of one repeated batch of 128 (the loss must fall),
   step-1 loss on the first 8 images equal to the CPU port's (rel 1e-4),
   the steady step against its operations bound, one profiled step; then
   TinyCNN's 6 steps against the CPU port's curve; then the moe, hybrid
   and ssm families through ``Session.train(3, seq_len=512,
   global_batch=2)`` at full width cut in depth (deepseek-v2-lite-16b 27
   -> 2 layers, recurrentgemma-2b to one super-block, rwkv6-1.6b 24 -> 4),
   the losses fall, K9 and K10 never launch, K3 launches steps x
   attention layers x 2 (remat), one profiled step each; recurrentgemma,
   whose training launches K3, again with ``use_kernels=False`` from the
   same init: step-1 loss and grad norm agree (rel 2e-3 / 1e-2);
7. deepseek serve — full-width ``deepseek-v2-lite-16b`` (27 layers, MLA
   with kv_lora_rank 512, 64 experts top-6 + 2 shared; random weights from
   a seed) served like qwen above with the kernels on (K6 decode, K7
   absorbed prefill and verify; their counts zeroed just before and read
   just after, each must be launched); the same drive again with every
   K6 / K7 launch held against its plain version on that launch's inputs;
   the ``use_kernels=False`` arm (K6's plain decode and the expanded MLA
   prefill), whose partings are printed; then profiled on the warm engine;
8. deepseek fp32 — the same model cut to 9 of its 27 layers (the run's
   time limit) and requests in fp32, kernels on and off: teacher-forced
   logits of the two paths agree within 1e-3, and the greedy streams
   match or part only at fp32 near-ties;
9. recurrent serve — full-width ``recurrentgemma-2b`` and ``rwkv6-1.6b``
   (random weights from a seed) served like qwen on the slotted pool
   (``kv_layout="auto"``), kernels on, recurrentgemma's requests with a
   seventh of 2,100 tokens past its 2048-token local window: every count
   zeroed just before and read just after; K9 must be launched 18 times,
   K3 8 times (rg) and K10 24 times (rwkv) per prefill; the drive again
   with every K3 / K9 / K10
   launch held against its plain version on that launch's inputs; the
   ``use_kernels=False`` arm, whose partings are printed; a profile of
   the drive;
10. recurrent fp32 — both models in fp32, kernels on and off: the
   teacher-forced logits of the two paths agree within 1e-3 and the
   greedy streams match or part only at fp32 near-ties; for rwkv6 the
   longest request's tokens then go through both paths layer by layer,
   printing each layer's difference and the first layer that grows it
   more than 10x (where the logits gap is amplified);
11. mixtral serve — full-width ``mixtral-8x22b`` cut to 4 of its 56 layers
   (sliding window 4096, 8 experts top-2) on ring pages: the six requests
   and a 4,200-token one in 1024-token chunks, whose fifth chunk and
   decode wrap the ring, profiled (the cold profile: K5's share of device
   time while the long prompt is prefilled chunk by chunk, and TTFT).  K4
   must launch 4 x decode steps and K5 4 x (prefill chunks + verifies),
   and the pool must rotate ring cells; then
   the checked drive, the ``use_kernels=False`` arm (partings printed), a
   profile of the warm engine (the long prompt a ring prefix hit); then
   the int8 arm as for qwen; then in fp32, kernels on and off,
   teacher-forced logits within 1e-3.  qwen's serve phase (4-5) ends the
   same way with an int8 arm: ``kv_dtype="int8"``, K8 in K1 and K2 must
   launch, page bytes against a bf16 page and the partings from the bf16-
   page streams printed, every K8 launch of a checked drive held against
   its plain version;
12. encdec / vlm — ``whisper-tiny`` at full config (4 + 4 layers,
   d_model 384, hd 64, 1,500 frames) and ``pixtral-12b`` at full width and
   depth (40 layers, 12.27 B params, its seeded bf16 weights only) through
   the registry bundles' ``prefill_fn`` / ``decode_fn``: whisper 4
   requests of seeded frames and a 16-token prompt, 32 greedy steps, K3
   counted at 4 encoder + 4 self + 4 cross launches in prefill and 4
   cross a step (bidirectional, and Sq 1 against 1,500 keys); pixtral 2
   requests of 1,024 seeded patch embeddings and 32 tokens, 16 steps, K3
   once a layer (causal over 1,056); each drive again with every K3
   launch held against its plain version, profiled; pixtral's
   ``use_kernels=False`` arm parting only at bf16 near-ties; fp32 arms
   (pixtral cut to 8 layers), teacher-forced logits within 1e-3; then
   training through ``TransparentTrainer.from_bundle`` on batches that
   carry frames / patches, in a one-rank NCCL group: whisper 6 steps of 8
   x 448 tokens, pixtral cut to 2 layers 3 steps of 2 x 512, K3 steps x
   attention layers x 2 (remat), kernel and plain arms agreeing at step 1;
   then ``python -m repro_torch.launch.serve --arch qwen2.5-14b
   --requests 8`` in a process of its own must exit 0;
13. mesh — two ranks of one gloo group share the card (``--mesh``);
14. analysis — (a) the threefry sampler on the card against the CPU over
   64 rows x qwen's 152,064-token vocabulary on identical fp32 logits:
   every raw bit equal, every sampled token equal but at a near-tie of
   the perturbed scores; (b) ``python -m repro_torch.roofline.profile_cell
   --device cuda`` in a process of its own on full-width qwen2.5-14b (48
   layers) cells: a prefill of 2 x 4,096 tokens (K3 must launch) and a
   decode step of 32 slots at a 4,096-token context — each prints the dry
   run's predicted terms and peak beside the card's step time, busy
   share, launches, time by kernel and peak memory (the prefill also with
   ``use_kernels=False``, the plain path the dry run counts); (c) in the qwen serve
   phase, the six requests sampled (temperature, top-k, top-p, a seed
   each), kernels on (K1 / K2 must launch), checked (every K1 / K2 launch
   against its plain version on its own inputs) and off; at each parting
   of the two arms, both serving paths' teacher-forced logits along the
   shared prefix are printed with what they draw and where the two tokens
   sit against the top-k / top-p edges; each parting must be a perturbed
   near-tie or a token at the top-k edge (4 bf16 ulps of the top logit);
15. each phase's wall seconds, a JSON ``kernels`` line, then as the
   last line ``{"ok": true, "device": {...}}``.

Drives that wrap Python functions decode eagerly and say so: the checked
drives, the sampled drive's recorded arms (a graphed sampled drive must
give the recorded kernel arm's streams), the mesh ranks (``decode_graphs``
resolves to False with a mesh); every other serve drive, plain arms
included, replays decode graphs.

    python3 chip_smoke.py --kernels K2,K6[,...] [SRC]

builds and times only the named kernels (K1, K2, K4, K5, K6, K7, K9,
K10, K11; the K8 branches come with K1, K2, K4 and K5) at the kernel
phase's cases — or, named KX14, KX2 and KX5, K1 / K4, K2 and K5 at
K-EXAONE's serving shapes (outside the full run's kernel phase) — from
the package under SRC (default this checkout's ``src``): two checkouts'
kernels side by side in one call.  ``--decode-kernels [SRC]`` is
``--kernels K1,K4 [SRC]``.  ``--train`` builds the kernels and runs the
train phase (6-7) alone, ``--encdec`` phase 12 alone, ``--mesh`` phase 13
alone, ``--analysis`` phase 14 alone (with the sampled qwen drive).

Exits with code 2 and prints no result when CUDA is unavailable.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: kernel-name markers of the device-time groups the profiles report
#: (cuBLAS GEMMs are nvjet / cutlass / gemm kernels on this stack)
GEMM_MARKS = ("nvjet", "gemm", "cutlass", "xmma")

#: H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor-core peak, and
#: the fp32 peak outside the tensor cores (K9 and K10 are fp32 scalar work)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
#: kernel vs plain version: both accumulate in fp32 and round once to bf16,
#: so they may differ by one bf16 ulp of the output; outputs are averages
#: of N(0, 1) values, |x| < 4, where one ulp is at most 2**-6
KERNEL_ATOL = 2.0 ** -6
#: fp32 decode kernel (K1 / K4 / K8) vs plain version: the same fp32 terms
#: summed in another order
FP32_KERNEL_ATOL = 1e-5
#: greedy streams may part only where the reference's top-two logits sit
#: within this many bf16 ulps of the top logit (a near-tie that fp32
#: summation order can flip)
TIE_ULPS = 4
SEED = 0
MAX_NEW = 32
#: deepseek-v2-lite serving geometry: heads, latent rank, rope dim, and
#: the qk-dimension softmax scale (qk_nope 128 + qk_rope 64) ** -0.5
MLA_H, MLA_R, MLA_RP, MLA_SCALE = 16, 512, 64, 192 ** -0.5
#: the drive's page table: auto-sized max_seq_len 128 at page 16
MLA_TABLE = 8
#: L2 flush between timed launches: the serving path reads each layer's
#: pages once per step with the other layers' weights in between, so the
#: pages arrive cold; 50 MB of L2 on the H100, flushed with 64 MB
FLUSH_BYTES = 64 << 20
#: K3's row logsumexp: kernel and plain version sum the same fp32 terms in
#: another order
LSE_RTOL = 1e-4
#: K3 gradients (fp32): max |err| over max |reference|
GRAD_RTOL = 1e-4
#: train drive: qwen2.5-14b at full width, depth cut 48 -> 4
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 4, 6, 2048, 2, 1e-4
#: step-1 agreement of the two train arms (bf16 compute: the two attention
#: paths round at other places)
LOSS_RTOL, GNORM_RTOL = 2e-3, 1e-2
#: K9 / K10 against their plain versions (fp32): max |err| over
#: max(1, max |plain|).  K9 runs the plain version's recurrence in its
#: order (expf may differ in the last ulp); K10 sums each output over the
#: 64-long state column in another order than the plain einsum
LRU_RTOL, WKV_RTOL = 1e-5, 1e-4


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device ms of ``fn`` over ``iters`` launches, each timed with
    CUDA events after an L2 flush (the flush is outside the events).  The
    events take in the host's time to enqueue ``fn`` where it outlasts the
    flush: tens of microseconds for a Python wrapper (``device_ms`` leaves
    it out)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def device_ms(torch, fn, iters=20):
    """Device time of the CUDA kernels one call of ``fn`` launches
    (torch.profiler, kernel time only: no host enqueue time), each call
    after an L2 flush whose own kernels are left out: the median over
    ``iters`` calls, since now and then one call of a profile reads many
    times slower than the rest (the mean over the profile where its trace
    holds no flush-delimited call).  NaN (not measured) when three
    profiles in a row record none of ``fn``'s kernels."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush.zero_()
        torch.cuda.synchronize()
    skip = {name for _, _, name in device_kernels(torch, prof)}
    for _ in range(3):          # the profiler now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        # a flush's kernel starts each call; the kernels after it are fn's
        calls = []
        for e in sorted((e for e in prof.events() if e.device_type == cuda),
                        key=lambda e: e.time_range.start):
            if e.name in skip:
                calls.append(0.0)
            elif calls:
                calls[-1] += e.time_range.elapsed_us()
        calls = sorted(c for c in calls if c > 0)
        if calls:
            return calls[len(calls) // 2] / 1e3
        # no flush-delimited call in the trace: the mean over the profile
        total = sum(us for us, _, name in device_kernels(torch, prof)
                    if name not in skip)
        if total > 0:
            return total / 1e3 / iters
    return math.nan             # not measured


def bound(bytes_moved, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1-2: environment and build
# ---------------------------------------------------------------------------

def env_phase(torch):
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(f"nvidia-smi: {smi[0]}")
    return smi[0]


def _demangle(names):
    """Readable kernel names (``c++filt`` where the machine has it)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def _ptxas_report(text):
    """(kernel, "N registers, spills") of each entry function in an
    ``-Xptxas -v`` log."""
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            regs = line.split("Used")[1].split(",")[0].strip()
            rows.append((fn, f"{regs}; {spill}"))
            fn = None
    return list(zip(_demangle([f for f, _ in rows]), (r for _, r in rows)))


#: the sources whose bf16 kernels run on the tensor cores: the (mangled)
#: name of their bf16 kernels, how many instantiations each library holds
#: (K3: hd 64 / 128 / 256; K2, K5: hd 64 / 128 x fp / int8 pages; K1 / K4:
#: hd 64 / 128 / 256 x fp / int8 pages; K6, K7: the two MLA geometries) and the
#: SASS op they must issue (HGMMA: wgmma; HMMA: mma.sync)
TENSOR_CORE_KERNELS = {
    "flash_attention": ("flash_fwd_kernel_wgmma", 3, "HGMMA"),
    "paged_prefill": ("paged_prefill_wgmma_kernel", 4, "HGMMA"),
    "paged_ring_prefill": ("paged_prefill_wgmma_kernel", 4, "HGMMA"),
    "paged_attention": ("paged_decode_kernelI13__nv_bfloat16", 6, "HMMA"),
    "paged_mla": ("paged_mla_decode_kernel_mma", 2, "HMMA"),
    "paged_mla_prefill": ("paged_mla_prefill_kernel_mma", 2, "HMMA")}


def tensor_core_check(build):
    """``cuobjdump -sass`` of the built K3, K2, K5, K1 / K4 and K6
    libraries: the tensor-core instructions of every kernel; each bf16
    instantiation must issue them."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    for name, (kernel, want, op) in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([str(tool), "-sass", str(build.lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs = {}
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                funcs[fn] = 0
            elif fn is not None and op in line:
                funcs[fn] += 1
        for readable, (fn, n) in zip(_demangle(list(funcs)), funcs.items()):
            log(f"  sass {name}: {n:5d} {op}  {readable[:110]}")
        mma = [n for fn, n in funcs.items() if kernel in fn]
        if len(mma) != want or not all(mma):
            raise AssertionError(f"{name}: {len(mma)} {kernel} instantiations "
                                 f"(want {want}), {op} counts {mma}")


#: readable kernel name -> "N registers; spills" from the build's ptxas log
PTXAS = {}


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        for fn, info in _ptxas_report(text):
            PTXAS[fn] = info
            log(f"  ptxas {name}: {info}  {fn[:110]}")
    log(f"build: {len(logs)} sources in {dt:.2f} s")
    tensor_core_check(build)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

#: main-path geometry of qwen2.5-14b served on the paged pool
SLOTS, KV, G, HD, PS = 8, 8, 5, 128, 16


def _table_rows(torch, lengths, n_table, n_pages, seed):
    """Distinct random pages per row for its held blocks, trash page 0
    after them."""
    cpu = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_pages - 1, generator=cpu) + 1
    rows = torch.zeros((len(lengths), n_table), dtype=torch.int32)
    for s, n in enumerate(lengths):
        held = -(-n // PS)
        rows[s, :held] = perm[s * n_table:s * n_table + held]
    return rows.cuda()


def cuda_launches(torch, fn):
    """CUDA kernels one call of ``fn`` launches, as ``torch.profiler``
    records them (0: the profiler recorded none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(n for _, n, _ in device_kernels(torch, prof))


def _sms(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def _decode_splits(torch, pk, kv, n_table, window):
    """The decode launch's split count at this case's shapes (1 for a tree
    whose decode kernel does not split: ``--decode-kernels`` on an older
    checkout)."""
    if not hasattr(pk, "decode_splits"):
        return 1
    return pk.decode_splits(SLOTS, kv, n_table, PS, window, _sms(torch))


def _prefill_splits(torch, pk, S, g, kv, start, n_valid, window=0):
    """The bf16 K2 / K5 launch's split count at this case's shapes (1 for
    a tree whose kernel does not split: ``--kernels`` on an older
    checkout)."""
    sms = _sms(torch)
    if hasattr(pk, "prefill_splits"):
        return pk.prefill_splits(S, g, kv, start, n_valid, sms, window)
    if window and hasattr(pk, "ring_prefill_splits"):
        return pk.ring_prefill_splits(S, g, kv, start, n_valid, window, sms)
    return 1


def _decode_row(torch, dtype, int8, splits):
    """What the K1 / K4 / K8 rows carry beside the check: the split count,
    the tolerance by dtype, and the instantiation's registers and spills
    (``-Xptxas -v``)."""
    t = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
    inst = f"paged_decode_kernel<{t}, {'signed char' if int8 else t}, {HD}>"
    regs = next((v for k, v in PTXAS.items() if inst in k),
                "not measured (the library was built before this run)")
    return dict(splits=splits, ptxas=f"{inst}: {regs}",
                tol=FP32_KERNEL_ATOL if dtype == torch.float32
                else KERNEL_ATOL)


def k1_case(torch, F, gen, dtype=None, int8=False, timed=True):
    """K1 at qwen's decode shape; ``int8``: its K8 branch."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    dtype = dtype or torch.bfloat16
    n_table = 16
    n_pages = SLOTS * n_table + 1
    lengths = [1, PS, PS + 1, n_table * PS, 100, 37, 200, 64]
    k, v, kw = _page_pair(torch, gen, (n_pages, PS, KV, HD), dtype, int8)
    q = torch.randn((SLOTS, KV * G, HD), generator=gen,
                    device="cuda").to(dtype)
    table = _table_rows(torch, lengths, n_table, n_pages, SEED + 1)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def kern():
        return ops.paged_attention(q, k, v, table, lens, use_kernel=True,
                                   **kw)

    def plain():
        return ref.paged_attention_ref(q, k, v, table, lens, **kw)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    splits = _decode_splits(torch, pk, KV, n_table, 0)
    case = dict(case=f"{'int8' if int8 else 'fp'} {str(dtype)[6:]} slots="
                     f"{SLOTS} KV={KV} G={G} hd={HD} ps={PS} lengths="
                     f"{lengths} splits={splits}", max_abs_err=err,
                **_decode_row(torch, dtype, int8, splits))
    if not timed:
        return case

    # library yardstick: SDPA over the pre-gathered (dequantized) [slots,
    # KV, T, hd] K/V
    T = n_table * PS
    idx = table.long()
    kg = _gather(torch, k, kw, "k", idx, dtype).reshape(
        SLOTS, T, KV, HD).transpose(1, 2).contiguous()
    vg = _gather(torch, v, kw, "v", idx, dtype).reshape(
        SLOTS, T, KV, HD).transpose(1, 2).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = (lib()[:, :, 0].float() - want.float()).abs().max().item()
    tokens = sum(lengths)
    nbytes = (q.numel() * q.element_size() * 2          # q in, out
              + _page_bytes(tokens * KV, dtype, int8)   # K and V needed
              + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * HD * G * KV * tokens
    b_ms, b_by = bound(nbytes, flops)
    return dict(case, ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lib), library_max_abs_err=lib_err,
                launches_per_call=cuda_launches(torch, kern),
                device_ms=device_ms(torch, kern),
                library_device_ms=device_ms(torch, lib))


def k2_case(torch, F, gen, S, start, n_valid, dtype=None, int8=False,
            timed=True):
    """K2 at qwen's prefill / verify shapes; ``int8``: its K8 branch."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    dtype = dtype or torch.bfloat16
    n_table = 32
    n_pages = n_table + 8
    k, v, kw = _page_pair(torch, gen, (n_pages, PS, KV, HD), dtype, int8)
    q = torch.randn((S, KV * G, HD), generator=gen, device="cuda").to(dtype)
    row = _table_rows(torch, [start + n_valid], n_table, n_pages,
                      SEED + S + start)[0]

    def kern():
        return ops.paged_prefill(q, k, v, row, start, n_valid,
                                 use_kernel=True, **kw)

    def plain():
        return ref.paged_prefill_ref(q, k, v, row, start, n_valid, **kw)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out[:n_valid].float() - want[:n_valid].float()).abs().max().item()
    splits = 1 if dtype == torch.float32 else _prefill_splits(
        torch, pk, S, G, KV, start, n_valid)
    case = dict(case=f"{'int8' if int8 else 'fp'} {str(dtype)[6:]} S={S} "
                     f"start={start} n_valid={n_valid} KV={KV} G={G} hd={HD} "
                     f"ps={PS} splits={splits}", max_abs_err=err,
                tol=FP32_KERNEL_ATOL if dtype == torch.float32
                else KERNEL_ATOL)
    if not timed:
        return case

    T = n_table * PS
    idx = row.long()
    kg = _gather(torch, k, kw, "k", idx, dtype).reshape(
        T, KV, HD).transpose(0, 1)[None].contiguous()
    vg = _gather(torch, v, kw, "v", idx, dtype).reshape(
        T, KV, HD).transpose(0, 1)[None].contiguous()
    kidx = torch.arange(T, device="cuda")
    qpos = start + torch.arange(S, device="cuda")
    mask = (kidx[None, :] < start + n_valid) & (kidx[None, :] <= qpos[:, None])
    qs = q.transpose(0, 1)[None].contiguous()

    def lib():
        return F.scaled_dot_product_attention(qs, kg, vg,
                                              attn_mask=mask[None, None],
                                              enable_gqa=True)

    lib_out = lib()[0].transpose(0, 1)
    lib_err = (lib_out[:n_valid].float()
               - want[:n_valid].float()).abs().max().item()
    keys = start + n_valid
    nbytes = (q.numel() * q.element_size() * 2
              + _page_bytes(keys * KV, dtype, int8) + row.numel() * 4)
    flops = 4 * HD * G * KV * sum(start + i + 1 for i in range(n_valid))
    b_ms, b_by = bound(nbytes, flops)
    return dict(case, ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lib), library_max_abs_err=lib_err,
                device_ms=device_ms(torch, kern),
                library_device_ms=device_ms(torch, lib))


#: (S, start, n_valid): verify rows (S = spec_tokens + 1 = 5) and prefill
#: buckets, cold (start 0) and after a prefix hit (start > 0), full and
#: ragged (n_valid < S); the last a verify after a 480-token prefix, whose
#: 8 key tiles take the bf16 kernel's split path
K2_CASES = ((5, 0, 5), (5, 37, 3), (16, 0, 11), (16, 32, 16), (64, 0, 40),
            (64, 64, 64), (256, 0, 200), (256, 48, 256), (5, 480, 5))
#: the K2 case the kernels line reports: a verify row mid-sequence, the
#: call the serving path makes most often
K2_REPORTED = (5, 37, 3)


#: mixtral-8x22b serving geometry: KV 8, G 6 (48 heads), hd 128, page 16,
#: a 4096-token window = a ring of 256 cells; the decode case's lengths
#: lie on both sides of the window and straddle pages
MX_KV, MX_G, MX_WINDOW = 8, 6, 4096
MX_CELLS = MX_WINDOW // PS
MX_LENGTHS = [1, 17, 4095, 4096, 4097, 4200, 333, 8191]


def _page_pair(torch, gen, shape, dtype, int8):
    """Random K and V pages: in ``dtype``, or int8 with bf16 scales made
    by the pool's quantizer.  Returns (k, v, scale kwargs)."""
    from repro_torch.serving.layouts import quantize_kv
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if not int8:
        return k.to(dtype), v.to(dtype), {}
    (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    return k, v, {"k_scale": ks, "v_scale": vs}


def _gather(torch, pages, kw, name, idx, dtype):
    """Pages gathered by ``idx`` (dequantized for int8) in ``dtype``: the
    library yardstick's K or V."""
    g = pages[idx].float()
    if kw:
        g = g * kw[name + "_scale"][idx].float()[..., None]
    return g.to(dtype)


def _page_bytes(rows, dtype, int8):
    """Bytes of ``rows`` K and V rows of HD elements (int8 rows with their
    bf16 scales)."""
    return rows * 2 * (HD + 2 if int8 else HD * dtype.itemsize)


def k4_case(torch, F, gen, dtype, int8, timed=True):
    """K4 (ring decode) at mixtral's decode shape; ``int8``: its K8
    branch."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    n_pages = SLOTS * MX_CELLS + 1
    k, v, kw = _page_pair(torch, gen, (n_pages, PS, MX_KV, HD), dtype, int8)
    q = torch.randn((SLOTS, MX_KV * MX_G, HD), generator=gen,
                    device="cuda").to(dtype)
    live = [min(n, MX_WINDOW) for n in MX_LENGTHS]
    table = _table_rows(torch, live, MX_CELLS, n_pages, SEED + 4)
    lens = torch.tensor(MX_LENGTHS, dtype=torch.int32, device="cuda")

    def kern():
        return ops.paged_attention(q, k, v, table, lens, window=MX_WINDOW,
                                   use_kernel=True, **kw)

    def plain():
        return ref.paged_attention_ref(q, k, v, table, lens,
                                       window=MX_WINDOW, **kw)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    splits = _decode_splits(torch, pk, MX_KV, MX_CELLS, MX_WINDOW)
    row = dict(case=f"{'int8' if int8 else 'fp'} {str(dtype)[6:]} slots="
                    f"{SLOTS} KV={MX_KV} G={MX_G} hd={HD} ps={PS} window="
                    f"{MX_WINDOW} lengths={MX_LENGTHS} splits={splits}",
               max_abs_err=err, **_decode_row(torch, dtype, int8, splits))
    if not timed:
        return row
    T = MX_CELLS * PS
    idx = table.long()
    kg = _gather(torch, k, kw, "k", idx, dtype).reshape(
        SLOTS, T, MX_KV, HD).transpose(1, 2).contiguous()
    vg = _gather(torch, v, kw, "v", idx, dtype).reshape(
        SLOTS, T, MX_KV, HD).transpose(1, 2).contiguous()
    _, ok = ref.ring_positions(lens, T, MX_WINDOW)
    mask = ok[:, None, None, :]
    qs = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = (lib()[:, :, 0].float() - want.float()).abs().max().item()
    tokens = sum(live)
    nbytes = (q.numel() * q.element_size() * 2 + _page_bytes(
        tokens * MX_KV, dtype, int8) + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * HD * MX_G * MX_KV * tokens
    b_ms, b_by = bound(nbytes, flops)
    return dict(row, ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, lib),
                library_max_abs_err=lib_err,
                launches_per_call=cuda_launches(torch, kern),
                device_ms=device_ms(torch, kern),
                library_device_ms=device_ms(torch, lib))


def _ring_pairs(S, start, n_valid, window):
    """(query, key) pairs the ring prefill's masks keep: the snapshot's
    live positions in each query's window, then the chunk's causal keys in
    it."""
    total = 0
    for i in range(n_valid):
        qpos = start + i
        lo = max(0, start - window, qpos - window + 1)
        total += max(0, start - lo) + min(i + 1, window)
    return total


def k5_case(torch, F, gen, dtype, int8, S, start, n_valid, timed=True):
    """K5 (ring chunked prefill, snapshot-before-write) at mixtral's shape
    on one request's ring of 256 cells; ``int8``: its K8 branch (int8
    snapshot pages, fp chunk operands)."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    n_pages = MX_CELLS + 8
    k, v, kw = _page_pair(torch, gen, (n_pages, PS, MX_KV, HD), dtype, int8)
    q = torch.randn((S, MX_KV * MX_G, HD), generator=gen,
                    device="cuda").to(dtype)
    ck = torch.randn((S, MX_KV, HD), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((S, MX_KV, HD), generator=gen, device="cuda").to(dtype)
    row = _table_rows(torch, [MX_WINDOW], MX_CELLS, n_pages, SEED + 5)[0]

    def kern():
        return ops.paged_ring_prefill(q, k, v, ck, cv, row, start, n_valid,
                                      window=MX_WINDOW, use_kernel=True,
                                      **kw)

    def plain():
        return ref.paged_ring_prefill_ref(q, k, v, ck, cv, row, start,
                                          n_valid, window=MX_WINDOW, **kw)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out[:n_valid].float() - want[:n_valid].float()).abs().max().item()
    # the bf16 kernel's split of its key tiles (fp32: the scalar kernel)
    splits = 1 if dtype == torch.float32 else _prefill_splits(
        torch, pk, S, MX_G, MX_KV, start, n_valid, MX_WINDOW)
    case = dict(case=f"{'int8' if int8 else 'fp'} {str(dtype)[6:]} S={S} "
                     f"start={start} n_valid={n_valid} KV={MX_KV} G={MX_G} "
                     f"hd={HD} ps={PS} window={MX_WINDOW} splits={splits}",
                max_abs_err=err)
    if not timed:
        return case
    T = MX_CELLS * PS
    idx = row.long()
    ring_pos, ring_ok = ref.ring_positions(
        torch.tensor([start], device="cuda"), T, MX_WINDOW)
    j = torch.arange(S, device="cuda")
    kpos = torch.cat([ring_pos[0], start + j])
    kok = torch.cat([ring_ok[0], j < n_valid])
    qpos = start + j
    mask = kok[None, :] & (kpos[None, :] <= qpos[:, None]) \
        & (kpos[None, :] > qpos[:, None] - MX_WINDOW)
    kk = torch.cat([_gather(torch, k, kw, "k", idx, dtype).reshape(
        T, MX_KV, HD), ck]).transpose(0, 1)[None].contiguous()
    vv = torch.cat([_gather(torch, v, kw, "v", idx, dtype).reshape(
        T, MX_KV, HD), cv]).transpose(0, 1)[None].contiguous()
    qs = q.transpose(0, 1)[None].contiguous()

    def lib():
        return F.scaled_dot_product_attention(qs, kk, vv,
                                              attn_mask=mask[None, None],
                                              enable_gqa=True)

    lib_out = lib()[0].transpose(0, 1)
    lib_err = (lib_out[:n_valid].float()
               - want[:n_valid].float()).abs().max().item()
    snap = min(start, MX_WINDOW)
    nbytes = (q.numel() * q.element_size() * 2
              + _page_bytes(snap * MX_KV, dtype, int8)
              + ck.numel() * ck.element_size() * 2 + row.numel() * 4)
    flops = 4 * HD * MX_G * MX_KV * _ring_pairs(S, start, n_valid,
                                                MX_WINDOW)
    b_ms, b_by = bound(nbytes, flops)
    return dict(case, ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lib), library_max_abs_err=lib_err,
                device_ms=device_ms(torch, kern),
                library_device_ms=device_ms(torch, lib))


#: K5 cases (S, start, n_valid): the drive's 1024-token chunk that wraps
#: the ring (reported), the ragged fifth chunk of its 4,200-token prompt
#: (bucket 128), a cold chunk, and a verify row (S = spec_tokens + 1,
#: one draft on a ring) past the window (reported beside the chunk: it
#: takes the bf16 kernel's split path)
K5_CASES = ((1024, 3584, 1024), (128, 4096, 104), (1024, 0, 1024),
            (5, 4210, 2))
K5_REPORTED = (1024, 3584, 1024)
K5_VERIFY = (5, 4210, 2)


def _valid_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the masks keep, counted from this case's shape."""
    total = 0
    for i in range(Sq):
        hi = min(i + 1, Sk) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def k3_case(torch, F, gen, B, S, H, KV_, hd, causal, window):
    """K3 at the training path's shapes: q [B*H, S, hd], k/v [B*KV, S, hd]
    in bf16; O against ``attention_ref`` and L against
    ``attention_lse_ref``."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    q = torch.randn((B * H, S, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B * KV_, S, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B * KV_, S, hd), generator=gen, device="cuda").bfloat16()

    def kern():
        return fk.flash_attention_kernel(q, k, v, causal=causal,
                                         window=window)

    def plain():
        return ref.attention_ref(q, k, v, causal=causal, window=window)

    (out, lse), want = kern(), plain()
    want_lse = ref.attention_lse_ref(q, k, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    lse_err = ((lse - want_lse).abs().max()
               / want_lse.abs().max()).item()

    q4, k4, v4 = (x.view(B, -1, S, hd) for x in (q, k, v))
    if window:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def lib():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  enable_gqa=True)
    else:
        def lib():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    lib_err = (lib().reshape(B * H, S, hd).float()
               - want.float()).abs().max().item()
    nbytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + lse.numel() * 4)
    flops = 4 * hd * B * H * _valid_pairs(S, S, causal, window)
    b_ms, b_by = bound(nbytes, flops)
    return dict(case=f"B={B} S={S} H={H} KV={KV_} hd={hd} causal={causal} "
                     f"window={window}",
                max_abs_err=err, lse_rel_err=lse_err,
                ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, lib),
                library_max_abs_err=lib_err, device_ms=device_ms(torch, kern),
                library_device_ms=device_ms(torch, lib))


#: (B, S, H, KV, hd, causal, window): the training shape of qwen2.5-14b at
#: 2 x 2048 tokens (reported), the same with a 512 sliding window, a ragged
#: length; recurrentgemma-2b's local-attention prefill (10 heads, one kv
#: head, hd 256, window 2048) at the drive's longest prompt and past the
#: window
K3_CASES = ((2, 2048, 40, 8, 128, True, 0), (2, 2048, 40, 8, 128, True, 512),
            (2, 1000, 40, 8, 128, True, 0), (1, 46, 10, 1, 256, True, 2048),
            (1, 2100, 10, 1, 256, True, 2048))


def k3_grad_check(torch):
    """The flash autograd Function (K3 forward, ``_bwd`` backward) against
    autograd through the plain version, fp32, S = 512: max |err| of dq,
    dk, dv over max |reference|."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.flash_vjp import flash_attention_vjp
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    B, S, H, KV_, hd = 2, 512, 40, 8, 128
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    k = torch.randn((B, S, KV_, hd), generator=gen, device="cuda")
    v = torch.randn((B, S, KV_, hd), generator=gen, device="cuda")
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention_vjp(*xs, use_kernel=True),
                              xs, do)
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(*ys, use_kernel=False),
                               ys, do)
    return {n: ((g - w).abs().max() / w.abs().max()).item()
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


def _mla_inputs(torch, gen, rows, n_pages):
    """bf16 latent queries [rows, H, R | rp] and latent pages [n_pages, PS,
    R | rp] at deepseek-v2-lite's width."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    return (rnd(rows, MLA_H, MLA_R), rnd(rows, MLA_H, MLA_RP),
            rnd(n_pages, PS, MLA_R), rnd(n_pages, PS, MLA_RP))


def _mla_sdpa(torch, F, q_lat, q_rope, ckv, kr, mask):
    """The library yardstick of K6 / K7: SDPA over keys [ckv | krope]
    gathered beforehand (one kv head shared by all H), values ckv, at the
    qk-dimension scale.  q_* [B, H, Sq, ·], ckv / kr [B, T, ·], mask
    [B, 1, Sq, T]."""
    q = torch.cat([q_lat, q_rope], dim=-1)
    k = torch.cat([ckv, kr], dim=-1)[:, None]
    v = ckv[:, None]
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True)


def _mla_bound(q_rows, keys, pairs):
    """bytes: q_lat + q_rope read and the latent output written once, the
    needed latent rows (ckv | krope) read once; operations: 2 (R + rp)
    for a score and 2 R for the PV product per (query, head, key) pair."""
    nbytes = (q_rows * MLA_H * (2 * MLA_R + MLA_RP) * 2
              + keys * (MLA_R + MLA_RP) * 2)
    flops = 2 * MLA_H * (2 * MLA_R + MLA_RP) * pairs
    return bound(nbytes, flops)


def k6_case(torch, F, gen, dtype=None, timed=True):
    """K6 at deepseek's decode shape (fp32: checked only); the bf16 case
    also times the kernel at forced split counts, where the wrapper takes
    them."""
    import inspect
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    dtype = dtype or torch.bfloat16
    n_pages = SLOTS * MLA_TABLE + 1
    lengths = [1, PS, PS + 1, MLA_TABLE * PS, 78, 46, 60, 33]
    q_lat, q_rope, ckv, kr = (t.to(dtype) for t in _mla_inputs(
        torch, gen, SLOTS, n_pages))
    table = _table_rows(torch, lengths, MLA_TABLE, n_pages, SEED + 2)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def kern():
        return ops.paged_mla_attention(q_lat, q_rope, ckv, kr, table, lens,
                                       scale=MLA_SCALE, use_kernel=True)

    def plain():
        return ref.paged_mla_attention_ref(q_lat, q_rope, ckv, kr, table,
                                           lens, scale=MLA_SCALE)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    split_arg = "_splits" in inspect.signature(pk.paged_mla_kernel).parameters
    splits = (pk.mla_decode_splits(SLOTS, MLA_TABLE, _sms(torch))
              if split_arg and dtype == torch.bfloat16 else 1)
    case = dict(case=f"{str(dtype)[6:]} slots={SLOTS} H={MLA_H} R={MLA_R} "
                     f"rp={MLA_RP} ps={PS} lengths={lengths} "
                     f"splits={splits}", max_abs_err=err,
                tol=FP32_KERNEL_ATOL if dtype == torch.float32
                else KERNEL_ATOL)
    if not timed:
        return case
    if split_arg:
        k6_split_sweep(torch, gen, lengths)
    T = MLA_TABLE * PS
    idx = table.long()
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])
    lib = _mla_sdpa(torch, F, q_lat[:, :, None], q_rope[:, :, None],
                    ckv[idx].reshape(SLOTS, T, MLA_R),
                    kr[idx].reshape(SLOTS, T, MLA_RP), mask[:, None, None])
    lib_err = (lib()[:, :, 0].float() - want.float()).abs().max().item()
    b_ms, b_by = _mla_bound(SLOTS, sum(lengths), sum(lengths))
    return dict(case, ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lib), library_max_abs_err=lib_err,
                device_ms=device_ms(torch, kern),
                library_device_ms=device_ms(torch, lib))


def k6_split_sweep(torch, gen, lengths):
    """The bf16 K6 kernel's device time at forced split counts, at the
    drive's lengths on its 8-page table and at 1024 tokens a slot on a
    64-page one (the data behind ``mla_decode_splits``)."""
    from repro_torch.kernels.paged_attention import kernel as pk
    for n_table, lens_ in ((MLA_TABLE, lengths), (64, [1024] * SLOTS)):
        n_pages = SLOTS * n_table + 1
        q_lat, q_rope, ckv, kr = _mla_inputs(torch, gen, SLOTS, n_pages)
        table = _table_rows(torch, lens_, n_table, n_pages, SEED + 3)
        lens = torch.tensor(lens_, dtype=torch.int32, device="cuda")
        counts = [n for n in (1, 2, 3, 4, 6, 8) if n <= n_table]
        sweep = {n: device_ms(torch, lambda n=n: pk.paged_mla_kernel(
            q_lat, q_rope, ckv, kr, table, lens, scale=MLA_SCALE,
            _splits=n)) for n in counts}
        log(f"K6 device ms by forced splits (table {n_table}, lengths "
            f"{lens_}; the wrapper picks "
            f"{pk.mla_decode_splits(SLOTS, n_table, _sms(torch))}): "
            + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))


def k7_case(torch, F, gen, S, start, n_valid, dtype=None, timed=True,
            splits=None):
    """K7 at deepseek's verify / prefill shapes; fp32, or bf16 at a forced
    split count (``splits``): checked only."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    dtype = dtype or torch.bfloat16
    n_pages = MLA_TABLE + 4
    q_lat, q_rope, ckv, kr = (t.to(dtype) for t in _mla_inputs(
        torch, gen, S, n_pages))
    row = _table_rows(torch, [start + n_valid], MLA_TABLE, n_pages,
                      SEED + S + start)[0]

    def kern():
        if splits:
            return pk.paged_mla_prefill_kernel(
                q_lat, q_rope, ckv, kr, row, start, n_valid,
                scale=MLA_SCALE, _splits=splits)
        return ops.paged_mla_prefill(q_lat, q_rope, ckv, kr, row, start,
                                     n_valid, scale=MLA_SCALE,
                                     use_kernel=True)

    def plain():
        return ref.paged_mla_prefill_ref(q_lat, q_rope, ckv, kr, row, start,
                                         n_valid, scale=MLA_SCALE)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out[:n_valid].float() - want[:n_valid].float()).abs().max().item()
    if (out[n_valid:] != 0).any():
        err = math.inf                      # padding rows must come back 0
    picked = (pk.mla_prefill_splits(S, start, n_valid, _sms(torch))
              if hasattr(pk, "mla_prefill_splits")
              and dtype == torch.bfloat16 else 1)
    case = dict(case=f"{str(dtype)[6:]} S={S} start={start} "
                     f"n_valid={n_valid} H={MLA_H} R={MLA_R} rp={MLA_RP} "
                     f"ps={PS} splits={splits or picked}"
                     f"{' (forced)' if splits else ''}",
                max_abs_err=err,
                tol=FP32_KERNEL_ATOL if dtype == torch.float32
                else KERNEL_ATOL)
    if not timed:
        return case
    T = MLA_TABLE * PS
    idx = row.long()
    kidx = torch.arange(T, device="cuda")
    qpos = start + torch.arange(S, device="cuda")
    mask = (kidx[None, :] < start + n_valid) & (kidx[None, :] <= qpos[:, None])
    lib = _mla_sdpa(torch, F, q_lat.transpose(0, 1)[None],
                    q_rope.transpose(0, 1)[None],
                    ckv[idx].reshape(1, T, MLA_R),
                    kr[idx].reshape(1, T, MLA_RP), mask[None, None])
    lib_out = lib()[0].transpose(0, 1)
    lib_err = (lib_out[:n_valid].float()
               - want[:n_valid].float()).abs().max().item()
    b_ms, b_by = _mla_bound(S, start + n_valid,
                            sum(start + i + 1 for i in range(n_valid)))
    return dict(case, ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lib), library_max_abs_err=lib_err,
                device_ms=device_ms(torch, kern),
                library_device_ms=device_ms(torch, lib))


def k7_split_sweep(torch, gen, S, start, n_valid):
    """The bf16 K7 kernel's device time at forced split counts (the data
    behind ``mla_prefill_splits``)."""
    from repro_torch.kernels.paged_attention import kernel as pk
    n_pages = MLA_TABLE + 4
    q_lat, q_rope, ckv, kr = _mla_inputs(torch, gen, S, n_pages)
    row = _table_rows(torch, [start + n_valid], MLA_TABLE, n_pages,
                      SEED + S + start)[0]
    sweep = {n: device_ms(torch, lambda n=n: pk.paged_mla_prefill_kernel(
        q_lat, q_rope, ckv, kr, row, start, n_valid, scale=MLA_SCALE,
        _splits=n)) for n in (1, 2, 3, 4, 8)}
    log(f"K7 device ms by forced splits at {(S, start, n_valid)} (the "
        f"wrapper picks {pk.mla_prefill_splits(S, start, n_valid, _sms(torch))}"
        f"): " + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))


#: (S, start, n_valid) of the deepseek drive: verify rows (S = 5) and the
#: prefill buckets of its 17-46-token prompts, cold and after the shared
#: 32-token prefix, full and ragged; and a verify after a 100-token prefix
#: (the bf16 kernel's split path, 4 key tiles a query block)
K7_CASES = ((5, 0, 5), (5, 37, 3), (5, 70, 5), (16, 32, 14), (32, 0, 23),
            (64, 0, 46), (5, 100, 5))
#: the K7 case the kernels line reports: a verify row mid-sequence, the
#: call the serving path makes most often
K7_REPORTED = (5, 37, 3)
#: forced split counts K7 is checked at (bf16, every ``K7_CASES`` shape)
K7_FORCED_SPLITS = (1, 2, 3, 8)


def _rel_err(out, want):
    """(max |out - want|, that over max(1, max |want|))."""
    err = (out.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def k9_case(torch, gen, B, S, W, split=None, exact=False, timed=True):
    """K9 at recurrentgemma-2b's prefill shape: log_a <= 0 and x [B, S, W]
    fp32 (the gates' outputs), h_{-1} = 0; at the split the wrapper picks,
    or checked only at a forced ``split`` (``exact``: one warp's run holds
    the sequence, so the result must be the plain version's bit for
    bit)."""
    from repro_torch.kernels.rglru_scan import kernel as lk
    from repro_torch.kernels.rglru_scan import ops, ref
    la = -torch.randn((B, S, W), generator=gen, device="cuda").abs()
    x = torch.randn((B, S, W), generator=gen, device="cuda")

    def kern():
        if split:
            return lk.lru_scan_kernel(la, x, _splits=split)
        return ops.lru_scan(la, x, use_kernel=True)

    def plain():
        return ref.lru_scan_ref(la, x)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    err, rel = _rel_err(out, want)
    picked = (lk.lru_scan_splits(S) if hasattr(lk, "lru_scan_splits")
              else None)
    case = dict(case=f"B={B} S={S} W={W} fp32"
                     + (f" split {tuple(split or picked)}" if picked else "")
                     + (" (forced)" if split else "")
                     + (", bit for bit" if exact else ""),
                max_abs_err=err, rel_err=rel, rel_tol=0.0 if exact
                else LRU_RTOL)
    if not timed:
        return case
    n = B * S * W
    b_ms, b_by = bound(12 * n, 3 * n, FP32_FLOPS_PER_S)
    return dict(case, ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=device_ms(torch, kern),
                library_device_ms=None)


def k9_split_sweep(torch, gen, B, S, W):
    """K9's device time at forced splits — super-chunks (the steps
    balanced over them) and warps a block, ``K9_SWEEP`` — beside its bytes
    bound: the data behind ``lru_scan_splits``."""
    import itertools
    from repro_torch.kernels.rglru_scan import kernel as lk
    la = -torch.randn((B, S, W), generator=gen, device="cuda").abs()
    x = torch.randn((B, S, W), generator=gen, device="cuda")
    b_ms, _ = bound(12 * B * S * W, 3 * B * S * W, FP32_FLOPS_PER_S)
    picked = lk.lru_scan_splits(S)
    splits = {picked}
    for n, w in itertools.product(*K9_SWEEP):
        sp = lk.lru_scan_splits(S, chunks=n, warps=w)
        if lk.lru_scan_smem(S, sp) <= lk.LRU_SMEM_MAX:
            splits.add(sp)
    sweep = {tuple(sp): device_ms(torch, lambda sp=sp: (
        lk.lru_scan_kernel(la, x, _splits=sp))) for sp in sorted(splits)}
    best = min(sweep, key=sweep.get)
    log(f"K9 device ms by forced split (warps, steps) at "
        f"{(B, S, W)}, bound {b_ms:.5f}; the wrapper picks {tuple(picked)} "
        f"({sweep[tuple(picked)]:.4f}, {sweep[tuple(picked)] / b_ms:.2f}x "
        f"bound), the fastest {best} ({sweep[best]:.4f}, "
        f"{sweep[best] / b_ms:.2f}x bound): "
        + ", ".join(f"{k}: {t:.4f}" for k, t in sweep.items()))


def k10_case(torch, gen, B, S, H, hd):
    """K10 at rwkv6-1.6b's width: r, k, v [B, S, H, hd], decays w in
    (0, 1), u [H, hd], s0 != 0 [B, H, hd, hd], fp32; outputs and the final
    state."""
    from repro_torch.kernels.rwkv6_wkv import ops

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = rnd(B, S, H, hd), rnd(B, S, H, hd), rnd(B, S, H, hd)
    w = torch.exp(-torch.exp(rnd(B, S, H, hd)))
    u, s0 = rnd(H, hd), rnd(B, H, hd, hd)

    def kern():
        return ops.wkv6(r, k, v, w, u, s0, use_kernel=True)

    def plain():
        return ops.wkv6(r, k, v, w, u, s0, use_kernel=False)

    (out, s_last), (want, want_s) = kern(), plain()
    torch.cuda.synchronize()
    err_o, rel_o = _rel_err(out, want)
    err_s, rel_s = _rel_err(s_last, want_s)
    log(f"K10 {(B, S, H, hd)}: out max |err| {err_o:.3g}, s_last max |err| "
        f"{err_s:.3g}")
    nbytes = 4 * (5 * B * S * H * hd + 2 * B * H * hd * hd + H * hd)
    b_ms, b_by = bound(nbytes, 4 * B * H * S * hd * hd, FP32_FLOPS_PER_S)
    return dict(case=f"B={B} S={S} H={H} hd={hd} fp32 s0!=0 (out and "
                     f"s_last)", max_abs_err=max(err_o, err_s),
                rel_err=max(rel_o, rel_s), rel_tol=WKV_RTOL,
                ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                device_ms=device_ms(torch, kern), library_device_ms=None)


#: (B, S, W): recurrentgemma-2b's lru width at the drive's prompt lengths
#: (17, 46; 46 reported), past the attention window and at the drive's
#: 2,100-token request, plus a ragged W
K9_CASES = ((1, 17, 2560), (1, 46, 2560), (1, 2049, 2560), (1, 46, 2500),
            (1, 2100, 2560))
K9_REPORTED = (1, 46, 2560)
#: forced splits K9 is checked at (every ``K9_CASES`` shape): 1, 2, 4 and
#: 8 warps a block (the super-chunks then follow the rule), and 16
#: super-chunks of the picked warps; and the sweep's super-chunks and
#: warps a block
K9_FORCED = ({"warps": 1}, {"warps": 2}, {"warps": 4}, {"warps": 8},
             {"chunks": 16})
K9_SWEEP = ((1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32), (2, 4, 8, 12, 16))
#: the sweep's shapes: past the window and the drive's prompts at
#: recurrentgemma's width
K9_SWEEP_SHAPES = ((1, 2049, 2560), (1, 46, 2560))
#: (B, S, W) where one warp's run holds the whole sequence: checked bit for
#: bit against the plain version
K9_EXACT = ((1, 1, 2560), (1, 17, 2560), (1, 46, 2560))
#: (B, S, H, hd): rwkv6-1.6b's heads at the drive's prompt lengths (46
#: reported) and past the kernel's 32-step staging chunk
K10_CASES = ((1, 17, 32, 64), (1, 46, 32, 64), (1, 200, 32, 64))
K10_REPORTED = (1, 46, 32, 64)


#: K11 (the MoE sorted route's grouped GEMM) cases, (N, n_valid, E, K, D,
#: F): deepseek-v2-lite's 512-token chunk (reported), a verify row of 5,
#: a bucket with 300 valid of 512, and mixtral-8x22b's 512-token chunk
K11_CASES = ((512, 512, 64, 6, 2048, 1408), (5, 5, 64, 6, 2048, 1408),
             (512, 300, 64, 6, 2048, 1408), (512, 512, 8, 2, 6144, 16384))
K11_REPORTED = K11_CASES[0]
#: K11 against its plain version, max |err| over max(1, max |plain|): in
#: bf16 both round h and each expert's output at the same points, and a
#: last-bit difference of their fp32 sums flips a rounding by one bf16 ulp
#: (2^-8 relative); in fp32 the same products summed in another order
MOE_RTOL = {"bfloat16": 2.0 ** -6, "float32": 1e-4}


def _moe_inputs(torch, gen, N, n_valid, E, K, D, Fd, dtype):
    """x [N, D]; expert weights scaled to keep h and the rows O(1); every
    token's K distinct experts drawn at random, padding rows past
    ``n_valid`` routed nowhere (expert E); gates renormalised."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    x = rnd(N, D)
    wg, wu = rnd(E, D, Fd, scale=D ** -0.5), rnd(E, D, Fd, scale=D ** -0.5)
    wd = rnd(E, Fd, D, scale=Fd ** -0.5)
    sel = torch.rand((N, E), generator=gen, device="cuda").argsort(1)[:, :K]
    sel[n_valid:] = E
    gates = torch.rand((N, K), generator=gen, device="cuda") + 0.1
    return x, wg, wu, wd, sel.reshape(-1), gates / gates.sum(1, keepdim=True)


def _old_sorted_route(torch, x, wg, wu, wd, flat_e, gates, K):
    """The sorted route as it was before K11, the yardstick: the group
    sizes read back to the host and one eager matmul chain an expert."""
    from repro_torch.models.moe import _expert
    cd, E = x.dtype, wg.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E + 1)[:E].tolist()
    tok, gate = order // K, gates.to(cd).reshape(-1)[order]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    lo = 0
    for e, c in enumerate(counts):
        if c:
            t = tok[lo:lo + c]
            ye = _expert(torch.nn.functional.silu, wg[e], wu[e], wd[e], x[t],
                         cd)
            acc.index_add_(0, t, ye.float() * gate[lo:lo + c, None].float())
        lo += c
    return acc


def k11_parts(torch, fn, iters=20):
    """Device ms a call of K11's three kernels (gate/up, down, combine) and
    of the rest of the wrapper's work (grouping, the tile table), from one
    profile of ``iters`` calls, each after an L2 flush."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    parts = {"gate_up": 0.0, "down": 0.0, "combine": 0.0, "table": 0.0}
    for us, _, name in device_kernels(torch, prof):
        if "moe_gemm" in name:
            parts["gate_up" if "true" in name else "down"] += us
        elif "moe_combine" in name:
            parts["combine"] += us
        elif "zero" not in name and "fill" not in name.lower():
            parts["table"] += us
    return {k: v / iters / 1e3 for k, v in parts.items()}


def k11_case(torch, gen, N, n_valid, E, K, D, Fd, dtype=None, timed=True):
    """K11 on one routed batch of picks against its plain version over the
    same tile table; timed (bf16) beside the plain version, the old loop
    and its bound: the touched experts' weights, x and the output."""
    from repro_torch.kernels.moe_grouped import kernel as mk
    from repro_torch.kernels.moe_grouped import ref
    dtype = dtype or torch.bfloat16
    x, wg, wu, wd, flat_e, gates = _moe_inputs(torch, gen, N, n_valid, E, K,
                                               D, Fd, dtype)

    def kern():
        return mk.moe_grouped(x, wg, wu, wd, flat_e, gates, first=0,
                              act="silu")

    order, tiles = ref.group_picks(flat_e, 0, E)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(N * K, device="cuda"))
    gate = gates.to(dtype).reshape(-1)[order]

    def plain():
        return ref.moe_grouped_ref(x, wg, wu, wd, order // K, gate, tiles,
                                   flat_e.view(N, K), inv.view(N, K),
                                   first=0, act="silu")

    n0 = mk.moe_grouped.launches
    out, want = kern(), plain()
    torch.cuda.synchronize()
    assert mk.moe_grouped.launches == n0 + 3
    err, rel = _rel_err(out, want)
    name = str(dtype)[6:]
    case = dict(case=f"{name} N={N} valid={n_valid} E={E} K={K} D={D} "
                     f"F={Fd} tiles={tiles.shape[0]}",
                max_abs_err=err, rel_err=rel, rel_tol=MOE_RTOL[name])
    if not timed:
        return case
    touched = int(torch.unique(flat_e[flat_e < E]).numel())
    picks = int((flat_e < E).sum())
    nbytes = (3 * touched * D * Fd + N * D) * 2 + N * D * 4
    b_ms, b_by = bound(nbytes, 6 * picks * D * Fd)

    def old():
        return _old_sorted_route(torch, x, wg, wu, wd, flat_e, gates, K)

    return dict(case, ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                old_loop_ms=time_ms(torch, old), bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=device_ms(torch, kern),
                library_device_ms=None, parts=k11_parts(torch, kern))


def _rows_k11(torch, F, gen):
    rows = [k11_case(torch, gen, *c) for c in K11_CASES]
    rows += [k11_case(torch, gen, *c, dtype=torch.float32, timed=False)
             for c in K11_CASES[:3]]
    return {"moe_grouped": rows}


def moe_summary(rows):
    """K11 at every timed case: device time beside its bound, the old
    loop's and the plain version's times."""
    for c, r in zip(K11_CASES, rows.get("moe_grouped", ())):
        log(f"K11 {c}: device {r['device_ms']:.4f} ms (events "
            f"{r['ms']:.4f}), bound {r['bound_ms']:.4f} ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['device_ms']:.1f}%); old loop "
            f"{r['old_loop_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; parts "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["parts"].items()))


def report_row(name, r):
    """Print one kernel case (its check, and its times where it was
    timed); returns whether it agrees with its plain version."""
    if "rel_tol" in r:
        ok = r["rel_err"] <= r["rel_tol"]
        check = (f"max_abs_err {r['max_abs_err']:.3g}, over max(1, "
                 f"|plain|) {r['rel_err']:.3g} (tol {r['rel_tol']:.3g})")
    else:
        tol = r.get("tol", KERNEL_ATOL)
        ok = r["max_abs_err"] <= tol
        check = f"max_abs_err {r['max_abs_err']:.3g} (tol {tol:.3g})"
    if "lse_rel_err" in r:
        ok = ok and r["lse_rel_err"] <= LSE_RTOL
        check += f"; L rel err {r['lse_rel_err']:.3g} (tol {LSE_RTOL:.3g})"
    if "ptxas" in r:                          # K1 / K4 / K8
        check += f"; {r['ptxas']}"
    if "ms" not in r:                         # checked, not timed
        log(f"kernel {name} [{r['case']}]: {check} {'ok' if ok else 'FAIL'}")
        return ok
    lib = ("library_ms none (no single PyTorch call computes it)"
           if r["library_ms"] is None else
           f"library_ms {r['library_ms']:.4f} (sdpa, err "
           f"{r['library_max_abs_err']:.3g})")
    calls = (f"; CUDA launches a call {r['launches_per_call']}"
             if "launches_per_call" in r else "")
    if "device_ms" in r:
        calls += f"; device_ms {r['device_ms']:.4f}"
        if r.get("library_device_ms") is not None:
            calls += f" (sdpa {r['library_device_ms']:.4f})"
    log(f"kernel {name} [{r['case']}]: {check} {'ok' if ok else 'FAIL'}; ms "
        f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
        f"{r['bound_ms']:.5f} ({r['bound_by']}) {lib}{calls}")
    return ok


# the kernel phase's rows of each paged kernel: kernels-line name -> cases
# (the timed bf16 case first, then those only checked)

def _rows_k1(torch, F, gen):
    bf16, fp32 = torch.bfloat16, torch.float32
    return {"paged_attention": [k1_case(torch, F, gen),
                                k1_case(torch, F, gen, fp32, timed=False)],
            "paged_attention_int8": [
                k1_case(torch, F, gen, bf16, True),
                k1_case(torch, F, gen, fp32, True, timed=False)]}


def _rows_k4(torch, F, gen):
    bf16, fp32 = torch.bfloat16, torch.float32
    return {"paged_ring_decode": [k4_case(torch, F, gen, bf16, False),
                                  k4_case(torch, F, gen, fp32, False,
                                          timed=False)],
            "paged_ring_decode_int8": [
                k4_case(torch, F, gen, bf16, True),
                k4_case(torch, F, gen, fp32, True, timed=False)]}


def _rows_k2(torch, F, gen):
    """K2 and its K8 branch timed in bf16 at every ``K2_CASES`` shape;
    fp32 checked at every shape (int8: at two)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    return {"paged_prefill": [k2_case(torch, F, gen, *c) for c in K2_CASES]
            + [k2_case(torch, F, gen, *c, fp32, timed=False)
               for c in K2_CASES],
            "paged_prefill_int8": [k2_case(torch, F, gen, *c, bf16, True)
                                   for c in K2_CASES]
            + [k2_case(torch, F, gen, *c, fp32, True, timed=False)
               for c in (K2_REPORTED, (64, 0, 40))]}


def _rows_k5(torch, F, gen):
    bf16, fp32 = torch.bfloat16, torch.float32
    return {"paged_ring_prefill": [k5_case(torch, F, gen, bf16, False, *c)
                                   for c in K5_CASES] + [
                k5_case(torch, F, gen, fp32, False, *c, timed=False)
                for c in K5_CASES],
            "paged_ring_prefill_int8": [
                k5_case(torch, F, gen, bf16, True, *K5_REPORTED),
                k5_case(torch, F, gen, bf16, True, *K5_VERIFY),
                k5_case(torch, F, gen, fp32, True, *K5_REPORTED,
                        timed=False)]}


def _rows_k6(torch, F, gen):
    return {"paged_mla": [k6_case(torch, F, gen),
                          k6_case(torch, F, gen, torch.float32,
                                  timed=False)]}


def _rows_k7(torch, F, gen):
    """K7 timed in bf16 at every ``K7_CASES`` shape (the last the long
    verify of the split path); checked in fp32 and, where the wrapper
    takes a count, at forced split counts, at every shape; the forced-
    split sweep of the long verify."""
    import inspect
    from repro_torch.kernels.paged_attention import kernel as pk
    rows = [k7_case(torch, F, gen, *c) for c in K7_CASES]
    rows += [k7_case(torch, F, gen, *c, torch.float32, timed=False)
             for c in K7_CASES]
    if "_splits" in inspect.signature(pk.paged_mla_prefill_kernel).parameters:
        rows += [k7_case(torch, F, gen, *c, timed=False, splits=n)
                 for c in K7_CASES for n in K7_FORCED_SPLITS]
        k7_split_sweep(torch, gen, *K7_CASES[-1])
    return {"paged_mla_prefill": rows}


def _rows_k9(torch, F, gen):
    """K9 timed at every ``K9_CASES`` shape; where the wrapper takes a
    split, checked at forced splits (``K9_FORCED``) at every shape and bit
    for bit at the one-run shapes; the forced-split sweeps
    (``K9_SWEEP_SHAPES``)."""
    from repro_torch.kernels.rglru_scan import kernel as lk
    rows = [k9_case(torch, gen, *c) for c in K9_CASES]
    if hasattr(lk, "lru_scan_splits"):
        rows += [k9_case(torch, gen, B, S, W, timed=False,
                         split=lk.lru_scan_splits(S, **force))
                 for B, S, W in K9_CASES for force in K9_FORCED]
        rows += [k9_case(torch, gen, B, S, W, split=lk.LruSplit(1, S),
                         exact=True, timed=False) for B, S, W in K9_EXACT]
        for c in K9_SWEEP_SHAPES:
            k9_split_sweep(torch, gen, *c)
    return {"lru_scan": rows}


def _rows_k10(torch, F, gen):
    return {"wkv6": [k10_case(torch, gen, *c) for c in K10_CASES]}


#: K-EXAONE's serving geometry (the ``kexaone-mixed`` cell): 64 query /
#: 8 KV heads of 128 (G 8), pages of 16, 32 slots, 512-token chunks; the
#: 12 global layers on contiguous pages (K1, K2; no rope there, which the
#: kernels never see) and the 36 windowed ones on a 128-token ring of 8
#: cells (K4, K5; a chunk is longer than the window)
KX_KV, KX_G, KX_WINDOW, KX_SLOTS, KX_SEQ = 8, 8, 128, 32, 16384
#: the decode case's 32 lengths: both sides of the window and of a page,
#: up to the cell's longest sequence
KX_LENGTHS = [1, 2, 16, 17, 127, 128, 129, 130, 200, 333, 511, 512, 700,
              1024, 1100, 1500, 2048, 2500, 3000, 3700, 4096, 5000, 6000,
              7000, 8191, 9000, 10000, 11000, 12345, 14000, 15360, 16384]
#: (S, start, n_valid) chunks: a prompt's first, an early and a late
#: 512-token chunk, the last chunk of the longest prompt, and a ragged
#: last chunk in a 64-token bucket (its short key walk takes the split
#: path); the first is reported
KX_CHUNKS = ((512, 0, 512), (512, 1024, 512), (512, 8192, 512),
             (512, 14848, 512), (64, 1536, 40))


def kx_decode_case(torch, gen, window, dtype, timed=True):
    """K1 (``window`` 0, a global layer) or K4 (a windowed layer) at
    K-EXAONE's decode step: 32 slots at ``KX_LENGTHS``."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    n_table = KX_WINDOW // PS if window else KX_SEQ // PS
    live = [min(n, window) if window else n for n in KX_LENGTHS]
    n_pages = sum(-(-n // PS) for n in live) + 8
    k, v, _ = _page_pair(torch, gen, (n_pages, PS, KX_KV, HD), dtype, False)
    q = torch.randn((KX_SLOTS, KX_KV * KX_G, HD), generator=gen,
                    device="cuda").to(dtype)
    cpu = torch.Generator().manual_seed(SEED + 41)
    perm = (torch.randperm(n_pages - 1, generator=cpu) + 1).tolist()
    table = torch.zeros((KX_SLOTS, n_table), dtype=torch.int32)
    for s, n in enumerate(live):
        held = -(-n // PS)
        table[s, :held] = torch.tensor(perm[:held], dtype=torch.int32)
        perm = perm[held:]
    table = table.cuda()
    lens = torch.tensor(KX_LENGTHS, dtype=torch.int32, device="cuda")

    def kern():
        return ops.paged_attention(q, k, v, table, lens, window=window,
                                   use_kernel=True)

    def plain():
        return ref.paged_attention_ref(q, k, v, table, lens, window=window)

    err = (kern().float() - plain().float()).abs().max().item()
    splits = pk.decode_splits(KX_SLOTS, KX_KV, n_table, PS, window,
                              _sms(torch))
    case = dict(case=f"{'K4' if window else 'K1'} {str(dtype)[6:]} slots="
                     f"{KX_SLOTS} KV={KX_KV} G={KX_G} hd={HD} ps={PS} "
                     f"window={window} lengths 1..{max(KX_LENGTHS)} "
                     f"splits={splits}", max_abs_err=err,
                tol=FP32_KERNEL_ATOL if dtype == torch.float32
                else KERNEL_ATOL)
    if not timed:
        return case
    tokens = sum(live)
    nbytes = q.numel() * q.element_size() * 2 + _page_bytes(
        tokens * KX_KV, dtype, False)
    b_ms, b_by = bound(nbytes, 4 * HD * KX_G * KX_KV * tokens)
    return dict(case, ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launches_per_call=cuda_launches(torch, kern),
                device_ms=device_ms(torch, kern))


def kx_prefill_case(torch, gen, ring, dtype, S, start, n_valid, timed=True):
    """K2 (a global layer's chunk, its keys written first) or K5 (a
    windowed layer's chunk, snapshot before write, longer than the window)
    at K-EXAONE's chunk shapes."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops, ref
    n_table = KX_WINDOW // PS if ring else KX_SEQ // PS
    n_pages = n_table + 8
    k, v, _ = _page_pair(torch, gen, (n_pages, PS, KX_KV, HD), dtype, False)
    q = torch.randn((S, KX_KV * KX_G, HD), generator=gen,
                    device="cuda").to(dtype)
    row = _table_rows(torch, [min(start + n_valid, n_table * PS)], n_table,
                      n_pages, SEED + 42 + S + start)[0]
    if ring:
        ck = torch.randn((S, KX_KV, HD), generator=gen,
                         device="cuda").to(dtype)
        cv = torch.randn((S, KX_KV, HD), generator=gen,
                         device="cuda").to(dtype)
        kern = lambda: ops.paged_ring_prefill(
            q, k, v, ck, cv, row, start, n_valid, window=KX_WINDOW,
            use_kernel=True)
        plain = lambda: ref.paged_ring_prefill_ref(
            q, k, v, ck, cv, row, start, n_valid, window=KX_WINDOW)
        snap = min(start, KX_WINDOW)
        pairs = _ring_pairs(S, start, n_valid, KX_WINDOW)
        nbytes = (q.numel() * q.element_size() * 2
                  + _page_bytes(snap * KX_KV, dtype, False)
                  + ck.numel() * ck.element_size() * 2)
    else:
        kern = lambda: ops.paged_prefill(q, k, v, row, start, n_valid,
                                         use_kernel=True)
        plain = lambda: ref.paged_prefill_ref(q, k, v, row, start, n_valid)
        pairs = sum(start + i + 1 for i in range(n_valid))
        nbytes = (q.numel() * q.element_size() * 2
                  + _page_bytes((start + n_valid) * KX_KV, dtype, False))
    err = (kern()[:n_valid].float()
           - plain()[:n_valid].float()).abs().max().item()
    splits = 1 if dtype == torch.float32 else _prefill_splits(
        torch, pk, S, KX_G, KX_KV, start, n_valid, KX_WINDOW if ring else 0)
    case = dict(case=f"{'K5' if ring else 'K2'} {str(dtype)[6:]} S={S} "
                     f"start={start} n_valid={n_valid} KV={KX_KV} G={KX_G} "
                     f"hd={HD} ps={PS}"
                     + (f" window={KX_WINDOW}" if ring else "")
                     + f" splits={splits}", max_abs_err=err,
                tol=FP32_KERNEL_ATOL if dtype == torch.float32
                else KERNEL_ATOL)
    if not timed:
        return case
    b_ms, b_by = bound(nbytes, 4 * HD * KX_G * KX_KV * pairs)
    return dict(case, ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                device_ms=device_ms(torch, kern))


def _rows_kx_decode(torch, F, gen):
    bf16, fp32 = torch.bfloat16, torch.float32
    return {"kexaone_decode": [
        kx_decode_case(torch, gen, w, bf16) for w in (0, KX_WINDOW)] + [
        kx_decode_case(torch, gen, w, fp32, timed=False)
        for w in (0, KX_WINDOW)]}


def _rows_kx_prefill(ring):
    def rows(torch, F, gen):
        bf16, fp32 = torch.bfloat16, torch.float32
        name = "kexaone_ring_prefill" if ring else "kexaone_prefill"
        return {name: [kx_prefill_case(torch, gen, ring, bf16, *c)
                       for c in KX_CHUNKS]
                + [kx_prefill_case(torch, gen, ring, fp32, *c, timed=False)
                   for c in (KX_CHUNKS[0], KX_CHUNKS[-1])]}
    return rows


#: ``--kernels`` names -> (the source to build, the kernel phase's rows)
KERNEL_ROWS = {"K1": ("paged_attention", _rows_k1),
               "K2": ("paged_prefill", _rows_k2),
               "K4": ("paged_attention", _rows_k4),
               "K5": ("paged_ring_prefill", _rows_k5),
               "K6": ("paged_mla", _rows_k6),
               "K7": ("paged_mla_prefill", _rows_k7),
               "K9": ("lru_scan", _rows_k9),
               "K10": ("wkv6", _rows_k10),
               "K11": ("moe_grouped", _rows_k11),
               # K1 / K4, K2 and K5 at K-EXAONE's shapes (``--kernels``
               # only: ``--kernels KX14,KX2,KX5``)
               "KX14": ("paged_attention", _rows_kx_decode),
               "KX2": ("paged_prefill", _rows_kx_prefill(False)),
               "KX5": ("paged_ring_prefill", _rows_kx_prefill(True))}


def k2_summary(rows):
    """K2 and its int8 branch against SDPA at every timed case, by device
    time; returns the index in ``K2_CASES`` of the prefill bucket (S > 5)
    where K2 stands worst against SDPA."""
    fp = [r for r in rows["paged_prefill"] if "ms" in r]
    q8 = [r for r in rows["paged_prefill_int8"] if "ms" in r]
    for c, r, rq in zip(K2_CASES, fp, q8):
        log(f"K2 {c}: device {r['device_ms']:.4f} ms = "
            f"{r['device_ms'] / r['library_device_ms']:.2f}x SDPA "
            f"{r['library_device_ms']:.4f} (events {r['ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f}); int8 {rq['device_ms']:.4f} ms = "
            f"{rq['device_ms'] / r['device_ms']:.3f}x fp, "
            f"{rq['device_ms'] / rq['library_device_ms']:.2f}x its SDPA "
            f"{rq['library_device_ms']:.4f}")
    return max((i for i, c in enumerate(K2_CASES) if c[0] > 5),
               key=lambda i: fp[i]["device_ms"] / fp[i]["library_device_ms"])


def k7_summary(rows):
    """K7 against SDPA at every ``K7_CASES`` shape, by device time."""
    for c, r in zip(K7_CASES, rows["paged_mla_prefill"]):
        log(f"K7 {c} ({r['case'].split('splits=')[1]} splits): device "
            f"{r['device_ms']:.4f} ms = "
            f"{r['device_ms'] / r['library_device_ms']:.2f}x SDPA "
            f"{r['library_device_ms']:.4f} (events {r['ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f}), {100 * r['bound_ms'] / r['device_ms']:.1f}"
            f"% of its bound")


def recurrent_summary(rows):
    """K9 and K10, where ``rows`` has them, by device time at every case,
    beside their bounds."""
    for name, key, cases in (("K9", "lru_scan", K9_CASES),
                             ("K10", "wkv6", K10_CASES)):
        for c, r in zip(cases, rows.get(key, ())):
            log(f"{name} {c}: device {r['device_ms']:.4f} ms (events "
                f"{r['ms']:.4f}), bound {r['bound_ms']:.5f} "
                f"({r['device_ms'] / r['bound_ms']:.2f}x)")


def kernels_only_phase(torch, F, names):
    """``--kernels``: the named paged kernels alone, in bf16 (timed) and
    fp32 (checked), as the kernel phase runs them — for holding two
    checkouts' kernels side by side in one call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for n in names:
        rows.update(KERNEL_ROWS[n][1](torch, F, gen))
    ok = all([report_row(name, r) for name, cases in rows.items()
              for r in cases])
    if "K2" in names:
        k2_summary(rows)
    if "K7" in names:
        k7_summary(rows)
    recurrent_summary(rows)
    moe_summary(rows)
    return ok


def kernel_phase(torch, F):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for name, (_, fn) in KERNEL_ROWS.items():
        if not name.startswith("KX"):
            rows.update(fn(torch, F, gen))
    rows["flash_attention"] = [k3_case(torch, F, gen, *c) for c in K3_CASES]
    failed = [f"{name} [{r['case']}]" for name, cases in rows.items()
              for r in cases if not report_row(name, r)]
    grads = k3_grad_check(torch)
    log(f"kernel flash_attention autograd (fp32, B=2 S=512 H=40 KV=8 "
        f"hd=128): max |err| / max |ref| "
        + " ".join(f"{n} {e:.3g}" for n, e in grads.items())
        + f" (tol {GRAD_RTOL:.3g})")
    if max(grads.values()) > GRAD_RTOL:
        failed.append(f"flash_attention autograd {grads}")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    k2, k2q = (next(r for r, c in zip(rows[n], K2_CASES) if c == K2_REPORTED)
               for n in ("paged_prefill", "paged_prefill_int8"))
    k2b = k2_summary(rows)
    k7_summary(rows)
    recurrent_summary(rows)
    moe_summary(rows)
    k7 = next(r for r, c in zip(rows["paged_mla_prefill"], K7_CASES)
              if c == K7_REPORTED)
    k9 = next(r for r, c in zip(rows["lru_scan"], K9_CASES)
              if c == K9_REPORTED)
    k10 = next(r for r, c in zip(rows["wkv6"], K10_CASES)
               if c == K10_REPORTED)
    k5 = next(r for r, c in zip(rows["paged_ring_prefill"], K5_CASES)
              if c == K5_REPORTED)
    k5v = next(r for r, c in zip(rows["paged_ring_prefill"], K5_CASES)
               if c == K5_VERIFY)
    k5q, k5qv = rows["paged_ring_prefill_int8"][:2]
    k3 = rows["flash_attention"][0]
    k1, k4 = rows["paged_attention"][0], rows["paged_ring_decode"][0]
    k1q, k4q = (rows["paged_attention_int8"][0],
                rows["paged_ring_decode_int8"][0])
    for what, r, rq in (("K4 (bf16, ring 4096)", k4, k4q),
                        ("K1 (bf16, qwen)", k1, k1q)):
        log(f"{what}: {r['ms']:.4f} ms in {r['splits']} splits = "
            f"{r['ms'] / r['library_ms']:.2f}x SDPA {r['library_ms']:.4f}; "
            f"int8 {rq['ms']:.4f} ms = {rq['ms'] / r['ms']:.3f}x fp.  Device "
            f"time only: {r['device_ms']:.4f} ms = "
            f"{r['device_ms'] / r['library_device_ms']:.2f}x SDPA "
            f"{r['library_device_ms']:.4f}, "
            f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of its bound; int8 "
            f"{rq['device_ms']:.4f} ms = "
            f"{rq['device_ms'] / r['device_ms']:.3f}x fp")
    log(f"K5 (bf16, S=1024 wrapping the ring): {k5['ms']:.4f} ms, SDPA "
        f"{k5['library_ms']:.4f}; verify S=5: {k5v['ms']:.4f} ms, SDPA "
        f"{k5v['library_ms']:.4f}; int8 {k5q['ms']:.4f} ms = "
        f"{k5q['ms'] / k5['ms']:.3f}x fp, int8 verify {k5qv['ms']:.4f} ms; "
        f"K3 (B=2 S=2048 causal): {k3['ms']:.4f} ms, SDPA "
        f"{k3['library_ms']:.4f} ({k3['ms'] / k3['library_ms']:.2f}x)")
    for what, r in (("K5 (S=1024 wrapping the ring)", k5),
                    ("K5 verify S=5", k5v), ("K3 (B=2 S=2048 causal)", k3)):
        log(f"{what}: device {r['device_ms']:.4f} ms = "
            f"{r['device_ms'] / r['library_device_ms']:.2f}x SDPA "
            f"{r['library_device_ms']:.4f}")

    def worst(name, reported):
        return dict(reported, max_abs_err=max(r["max_abs_err"]
                                              for r in rows[name]))

    def with_verify(row, verify, tag="verify"):
        return dict(row, **{f"{tag}_{k}": verify[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms") if k in verify})

    k6 = rows["paged_mla"][0]
    log(f"K6 (bf16, deepseek): device {k6['device_ms']:.4f} ms in "
        f"{k6['case'].split('splits=')[1]} splits = "
        f"{k6['device_ms'] / k6['library_device_ms']:.2f}x SDPA "
        f"{k6['library_device_ms']:.4f} (events {k6['ms']:.4f}, SDPA "
        f"{k6['library_ms']:.4f}); K7 verify: device {k7['device_ms']:.4f} "
        f"ms, SDPA {k7['library_device_ms']:.4f}")

    return {"paged_attention": worst("paged_attention",
                                     rows["paged_attention"][0]),
            "paged_ring_decode": worst("paged_ring_decode",
                                       rows["paged_ring_decode"][0]),
            "paged_ring_prefill": with_verify(
                worst("paged_ring_prefill", k5), k5v),
            **{n: worst(n, rows[n][0]) for n in INT8_KERNELS},
            "paged_ring_prefill_int8": with_verify(
                worst("paged_ring_prefill_int8", k5q), k5qv),
            # K2 and its int8 branch: the reported verify row, and the
            # prefill bucket where K2 stands worst against SDPA beside it
            "paged_prefill": with_verify(worst("paged_prefill", k2),
                                         rows["paged_prefill"][k2b],
                                         "bucket"),
            "paged_prefill_int8": with_verify(
                worst("paged_prefill_int8", k2q),
                rows["paged_prefill_int8"][k2b], "bucket"),
            "flash_attention": dict(rows["flash_attention"][0], max_abs_err=max(
                r["max_abs_err"] for r in rows["flash_attention"])),
            "paged_mla": worst("paged_mla", rows["paged_mla"][0]),
            "paged_mla_prefill": dict(k7, max_abs_err=max(
                r["max_abs_err"] for r in rows["paged_mla_prefill"])),
            "lru_scan": dict(k9, max_abs_err=max(
                r["max_abs_err"] for r in rows["lru_scan"])),
            "wkv6": dict(k10, max_abs_err=max(
                r["max_abs_err"] for r in rows["wkv6"])),
            "moe_grouped": worst("moe_grouped", rows["moe_grouped"][0])}


# ---------------------------------------------------------------------------
# phases 4-5 and 7: serve at full width, the checked drive, the plain arm
# ---------------------------------------------------------------------------

def make_prompts(vocab, repetitive, long=0):
    """Six requests: 0 and 3 share a 32-token (two-page) prefix — 3 is
    admitted a cycle after 0 committed its pages, so it hits the prefix
    cache; 4 is ``repetitive``, so the n-gram drafter proposes; with
    ``long``, a seventh request of that many tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED)

    def rand(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    shared = rand(32)
    prompts = [shared + rand(9), rand(23), rand(40), shared + rand(14),
               list(repetitive), rand(17)]
    return prompts + [rand(long)] if long else prompts


#: each drive's repetitive request.  Random-weight deepseek drafts nothing
#: on qwen's; a run of 30330, the token it repeats for seed 0 (found by
#: serving runs of its most-emitted token until one drew a draft), does;
#: mixtral (4 layers, seed 0) drafts on a run of 12898, found the same way.
#: The paged drives assert that drafts were verified; the slotted pool of
#: the recurrent families does not speculate.
REPETITIVE = {"qwen2.5-14b": [11, 12, 13, 14, 15, 16] * 6,
              "mixtral-8x22b": [12898] * 36,
              "deepseek-v2-lite-16b": [30330] * 36,
              "recurrentgemma-2b": [11, 12, 13, 14, 15, 16] * 6,
              "rwkv6-1.6b": [11, 12, 13, 14, 15, 16] * 6}

#: mixtral-8x22b at full width cut to 4 of its 56 layers (10.4 B
#: parameters, 19.4 GiB in bf16); its seventh request, 4,200 tokens in
#: 1024-token chunks, wraps the 4096-token ring in its fifth chunk and in
#: decode, so K4 and K5 run ring arithmetic and the pool rotates cells;
#: recurrentgemma-2b's, 2,100 tokens, runs its whole-prompt prefill past
#: the 2048-token local window: K9 at S 2100 (the scan's long-S split) and
#: K3 over a window shorter than the prompt
LOAD_KW = {"mixtral-8x22b": {"num_layers": 4}}
DRIVE_KW = {"mixtral-8x22b": {"prefill_chunk_tokens": 1024}}
LONG_PROMPT = {"mixtral-8x22b": 4200, "recurrentgemma-2b": 2100}
#: the drives whose first (cold) run is profiled: mixtral's long prompt
#: goes through K5 chunk by chunk only there
COLD_PROFILE = ("mixtral-8x22b",)

#: the kernels each serve drive runs, by family
SERVE_KERNELS = {"qwen2.5-14b": ("paged_attention", "paged_prefill"),
                 "mixtral-8x22b": ("paged_ring_decode", "paged_ring_prefill"),
                 "deepseek-v2-lite-16b": ("paged_mla", "paged_mla_prefill"),
                 "recurrentgemma-2b": ("flash_attention", "lru_scan"),
                 "rwkv6-1.6b": ("wkv6",)}


#: the int8 (K8) branches of K1, K2, K4 and K5, each counted apart from
#: its fp launches (``launches_by`` of the K1 / K4, K2 and K5 wrappers)
INT8_KERNELS = ("paged_attention_int8", "paged_prefill_int8",
                "paged_ring_decode_int8", "paged_ring_prefill_int8")
#: the int8 drives' kernels, by the layout of their pages
INT8_SERVE_KERNELS = {
    "qwen2.5-14b": ("paged_attention_int8", "paged_prefill_int8"),
    "mixtral-8x22b": ("paged_ring_decode_int8", "paged_ring_prefill_int8")}
#: kernels-line name -> (wrapper name, ``launches_by`` key) for the
#: wrappers that launch more than one kernel of the table
BY_PAGES = {"paged_attention": ("paged_attention", "fp"),
            "paged_ring_decode": ("paged_attention", "ring_fp"),
            "paged_attention_int8": ("paged_attention", "int8"),
            "paged_ring_decode_int8": ("paged_attention", "ring_int8"),
            "paged_prefill": ("paged_prefill", "fp"),
            "paged_prefill_int8": ("paged_prefill", "int8"),
            "paged_ring_prefill": ("paged_ring_prefill", "fp"),
            "paged_ring_prefill_int8": ("paged_ring_prefill", "int8")}
#: calls of the paged model entry points in a drive (decode steps, prefill
#: chunks, verifies), counted by ``count_model_calls``
MODEL_CALLS = {}


def count_model_calls():
    """Wrap the paged model entry points so a drive can count its decode
    steps, prefill chunks and verifies — installed before any session is
    loaded, since a bundle binds them when it is built."""
    from repro_torch.models import transformer
    for name in ("lm_paged_decode", "lm_paged_prefill", "lm_paged_verify"):
        def counted(*a, _fn=getattr(transformer, name), _name=name, **kw):
            MODEL_CALLS[_name] = MODEL_CALLS.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(transformer, name, counted)


def kernel_wrappers():
    """wrapper name -> the wrapper whose ``launches`` (and, for the paged
    per-head kernels, ``launches_by``) count its launches."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.rglru_scan import kernel as lk
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    return {"paged_attention": pk.paged_attention_kernel,
            "paged_prefill": pk.paged_prefill_kernel,
            "paged_ring_prefill": pk.paged_ring_prefill_kernel,
            "flash_attention": fk.flash_attention_kernel,
            "paged_mla": pk.paged_mla_kernel,
            "paged_mla_prefill": pk.paged_mla_prefill_kernel,
            "lru_scan": lk.lru_scan_kernel, "wkv6": wk.wkv6_kernel}


def launches_per_prefill(cfg):
    """The recurrent families' kernel launches in one whole-prompt prefill
    (their decode steps run no kernel): recurrentgemma-2b's 8 super-blocks
    (2 RG-LRU blocks and one local attention each) and 2 tail RG-LRU
    blocks — K9 18, K3 8; rwkv6-1.6b's 24 layers — K10 24."""
    if cfg.family == "hybrid":
        n_super, n_tail = divmod(cfg.num_layers, 3)
        return {"flash_attention": n_super, "lru_scan": 2 * n_super + n_tail}
    return {"wkv6": cfg.num_layers}


def moe_wrapper():
    """K11's wrapper.  The MoE sorted route has one algorithm on the card,
    the grouped GEMM, so plain arms (``use_kernels=False``) launch it too:
    it is counted apart from ``kernel_wrappers``."""
    from repro_torch.kernels.moe_grouped import kernel as mk
    return mk.moe_grouped


def reset_counts():
    for w in [*kernel_wrappers().values(), moe_wrapper()]:
        w.launches = 0
        if hasattr(w, "launches_by"):
            w.launches_by = {}
    MODEL_CALLS.clear()


def read_counts():
    """Kernels-line name -> launches since ``reset_counts``."""
    wrappers = kernel_wrappers()
    counts = {n: w.launches for n, w in wrappers.items()
              if not hasattr(w, "launches_by")}
    for name, (w, kind) in BY_PAGES.items():
        counts[name] = wrappers[w].launches_by.get(kind, 0)
    counts["moe_grouped"] = moe_wrapper().launches
    return counts


def plain_launches(counts):
    """``counts`` without K11, which every MoE arm on the card runs."""
    return {n: c for n, c in counts.items() if n != "moe_grouped"}


def check_moe_launches(cfg, counts, arm):
    """Every layer of every paged prefill chunk and verify runs the MoE
    sorted route once: K11's three launches (gate/up, down, combine)."""
    want = 3 * cfg.num_layers * (MODEL_CALLS.get("lm_paged_prefill", 0)
                                 + MODEL_CALLS.get("lm_paged_verify", 0))
    log(f"K11 launches ({arm}) {counts['moe_grouped']}: 3 x {cfg.num_layers}"
        f" layers x prefill chunks + verifies")
    if counts["moe_grouped"] != want:
        raise AssertionError(f"K11 launches {counts['moe_grouped']}, "
                             f"expected {want}")


#: the last drive's engine: its resolved ``decode_graphs``, graph count,
#: and the decode cycles and steps the drive ran (``drive_decode``)
DRIVE = {}


def engine_marks(sess):
    """Each cached engine's decode cycles and steps so far (weakly held:
    a drive may drop engines)."""
    return weakref.WeakKeyDictionary(
        {e: (e.decode_cycles, e.decode_steps_run)
         for e in sess._engines.values()})


def drive_decode(sess, marks):
    """The last drive's decode on its engine (``sess.engine``), against
    ``engine_marks`` taken before it: the decode cycles and the decode
    steps the card ran (graph warm-ups, replays and eager cycles), and
    how the engine resolved ``decode_graphs``."""
    eng = sess.engine
    cycles0, steps0 = marks.get(eng, (0, 0))
    g = eng._graphs
    return {"decode_graphs": eng.decode_graphs,
            "graphs": len(g) if g is not None else 0,
            "capture_s": g.capture_s if g is not None else 0.0,
            "cycles": eng.decode_cycles - cycles0,
            "steps": eng.decode_steps_run - steps0}


def serve_once(torch, sess, prompts, **overrides):
    """One drive of ``prompts`` (with the arch's ``DRIVE_KW``); every
    kernel's count is zeroed just before and read just after; the drive's
    decode (``DRIVE``) printed."""
    reset_counts()
    marks = engine_marks(sess)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = sess.serve(prompts, max_new=MAX_NEW,
                      **{**DRIVE_KW.get(sess.model.name, {}), **overrides})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    DRIVE.clear()
    DRIVE.update(drive_decode(sess, marks))
    knobs = {k: ("sampled" if k == "sampling" else v)
             for k, v in overrides.items()}
    log(f"  drive {sess.model.name} {knobs or ''}: decode_graphs="
        f"{DRIVE['decode_graphs']} ({DRIVE['graphs']} graphs captured so "
        f"far, {DRIVE['capture_s']:.2f} s warm-up + capture), "
        f"{DRIVE['cycles']} decode cycles, {DRIVE['steps']} decode steps "
        f"on the card, {wall:.2f} s")
    return outs, wall, read_counts(), sess.engine.metrics.summary()


def bf16_tie(top):
    """The near-tie tolerance at a top logit ``top``: TIE_ULPS bf16 ulps."""
    return TIE_ULPS * 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)


def logit_gap(torch, sess, prompt, tokens, j):
    """Top-two logit gap of the plain forward (the family's serving
    prefill without kernels; MoE routed per token, as serving routes it)
    at stream index ``j`` of ``tokens``, and the tie tolerance there
    (TIE_ULPS bf16 ulps of the top logit)."""
    seq = torch.tensor([list(prompt) + list(tokens[:j])], device=sess.device)
    with torch.no_grad():
        logits, _ = sess.bundle.serve_prefill_fn(
            sess.params, seq, cache_len=seq.shape[1], use_kernels=False)
    top = torch.topk(logits[0].float(), 2).values.tolist()
    return top[0] - top[1], bf16_tie(top[0])


def compare_streams(torch, sess, prompts, outs, plain, *, asserted):
    """Greedy streams of the kernel arm against the plain arm's: at each
    parting, the plain forward's top-two gap there must be a near-tie
    (``asserted``), or is only printed."""
    identical = 0
    for i, (a, b) in enumerate(zip(outs, plain)):
        if a == b:
            identical += 1
            continue
        j = next(k for k in range(len(a)) if a[k] != b[k])
        gap, tol = logit_gap(torch, sess, prompts[i], b, j)
        log(f"request {i}: streams part at index {j} ({a[j]} vs {b[j]}); "
            f"plain top-2 logit gap {gap:.4g} (tie tolerance {tol:.4g})")
        if asserted and gap > tol:
            raise AssertionError(f"request {i} diverges at {j} with top-2 gap "
                                 f"{gap} > {tol}")
    log(f"comparison with the plain arm: {identical}/{len(outs)} greedy "
        "streams identical" + (", the rest part only at bf16 near-ties"
                               if asserted else " (printed, not asserted)"))


#: the checked drives' limits: bf16 kernels (K3, K6, K7) may differ from
#: their plain versions by one bf16 ulp of the largest output (at least
#: KERNEL_ATOL); fp32 K9 / K10 by LRU_RTOL / WKV_RTOL of max(1, |plain|)
CHECK_LIMITS = {"flash_attention": "one bf16 ulp", "paged_mla": "one bf16 ulp",
                "paged_mla_prefill": "one bf16 ulp",
                **{n: "one bf16 ulp" for n in (
                    "paged_attention", "paged_prefill", "paged_ring_decode",
                    "paged_ring_prefill") + INT8_KERNELS},
                "lru_scan": f"{LRU_RTOL:g} rel", "wkv6": f"{WKV_RTOL:g} rel"}


@contextlib.contextmanager
def checked_launches(torch, names):
    """Hold every launch of the kernels ``names`` made inside against its
    plain version on the very inputs that launch was given (the pages as
    it saw them; K7 on its ``n_valid`` real rows; K10's outputs and final
    state).  Yields {name: [(max |kernel - plain|, that over its limit)
    of each launch, as device scalars]}."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
    from repro_torch.models import flash_vjp

    def bf16(out, want):
        err = (out.float() - want.float()).abs().max()
        top = want.float().abs().max()
        ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(top, min=1e-30)))
                         - 7)
        return err, err / torch.clamp(ulp, min=KERNEL_ATOL)

    def fp32(outs, wants, rtol):
        errs = [(o - w).abs().max() for o, w in zip(outs, wants)]
        rels = [e / torch.clamp(w.abs().max(), min=1.0)
                for e, w in zip(errs, wants)]
        return torch.stack(errs).max(), torch.stack(rels).max() / rtol

    def k7(out, a, kw):
        n = a[6]
        return bf16(out[:n], pa_ref.paged_mla_prefill_ref(*a, **kw)[:n])

    def heads(q):                 # [rows, KV, G, hd] -> [rows, H, hd]
        return q.reshape(q.shape[0], -1, q.shape[-1])

    def decode(out, a, kw):       # K1 / K4 and their int8 branches
        return bf16(out, pa_ref.paged_attention_ref(
            heads(a[0]), *a[1:], **kw).reshape(out.shape))

    def prefill(n_at, ref_fn):    # K2 / K5: the real rows only
        def check(out, a, kw):
            n = a[n_at]
            want = ref_fn(heads(a[0]), *a[1:], **kw).reshape(out.shape)
            return bf16(out[:n], want[:n])
        return check

    k2 = (pa_ops, "paged_prefill_kernel", prefill(5, pa_ref.paged_prefill_ref))
    k5 = (pa_ops, "paged_ring_prefill_kernel",
          prefill(7, pa_ref.paged_ring_prefill_ref))
    k14 = (pa_ops, "paged_attention_kernel", decode)

    # name -> (module the path looks the wrapper up in, attribute, check);
    # K3 is looked up in two modules: the flash autograd Function's and
    # the model-layout entry point's (whisper's cross-attention)
    sites = {
        "paged_attention": k14, "paged_ring_decode": k14,
        "paged_attention_int8": k14, "paged_ring_decode_int8": k14,
        "paged_prefill": k2, "paged_prefill_int8": k2,
        "paged_ring_prefill": k5, "paged_ring_prefill_int8": k5,
        "paged_mla": (pa_ops, "paged_mla_kernel", lambda out, a, kw: bf16(
            out, pa_ref.paged_mla_attention_ref(*a, **kw))),
        "paged_mla_prefill": (pa_ops, "paged_mla_prefill_kernel", k7),
        "flash_attention": ((flash_vjp, fa_ops), "flash_attention_kernel",
                            lambda out, a, kw: bf16(
                                out[0], fa_ref.attention_ref(*a, **kw))),
        "lru_scan": (lru_ops, "lru_scan_kernel", lambda out, a, kw: fp32(
            [out], [lru_ref.lru_scan_ref(*a)], LRU_RTOL)),
        "wkv6": (wkv_ops, "wkv6_kernel", lambda out, a, kw: fp32(
            out, wkv_ref.wkv6_model_ref(*a), WKV_RTOL)),
    }
    errs = {n: [] for n in names}

    def checked(name, fn, check):
        def run(*args, **kw):
            out = fn(*args, **kw)
            errs[name].append(check(out, args, kw))
            return out
        return run

    saved = []
    for n in names:
        mods, attr, check = sites[n]
        for mod in (mods if isinstance(mods, tuple) else (mods,)):
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, checked(n, saved[-1][2], check))
    try:
        yield errs
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def checked_drive(torch, sess, prompts, outs, names, **overrides):
    """The drive again on a cold engine of its own, every launch of the
    kernels ``names`` held against its plain version (CHECK_LIMITS): the
    kernels checked at the inputs the serving path gives them, prefill
    chunks, verify rows and decode steps alike.  The checks wrap Python
    functions, so this drive decodes eagerly (``decode_graphs=False``):
    it is the eager arm of the kernel drive ``outs``, whose greedy (or
    seeded) streams it must equal token for token — the same decode body
    and kernels, graphed there."""
    log("checked drive: the eager arm (decode_graphs=False; its checks "
        "wrap Python functions)")
    with checked_launches(torch, names) as errs:
        checked, wall, _, _ = serve_once(torch, sess, prompts,
                                         use_kernels=True,
                                         decode_graphs=False, **overrides)
    report_checked(torch, errs, wall)
    same = sum(a == b for a, b in zip(checked, outs))
    log(f"checked drive (eager) vs the kernel drive: {same}/{len(outs)} "
        "streams equal token for token")
    if checked != outs:
        raise AssertionError("the eager arm's streams differ from the "
                             "kernel drive's")


def report_checked(torch, errs, wall):
    """Print and assert what ``checked_launches`` gathered: each kernel
    launched, each launch within its limit."""
    for name, e in errs.items():
        if not e:
            raise AssertionError(f"checked drive: {name} never launched")
        worst = torch.stack([x for x, _ in e]).max().item()
        ratio = torch.stack([r for _, r in e]).max().item()
        log(f"checked drive ({wall:.2f} s): {name}, {len(e)} launches, each "
            f"against its plain version on its own inputs: max |err| "
            f"{worst:.3g}, worst err / limit {ratio:.3g} (limit "
            f"{CHECK_LIMITS[name]})")
        if ratio > 1.0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the drive's inputs: {worst}")


def device_kernels(torch, prof):
    """(device us, launches, name) of every CUDA kernel a profile holds."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((us, e.count, e.key))
    return kernels


def report_profile(kernels, wall, what, marks=()):
    """Print a drive's device busy share, the GEMMs' share of device time
    and each marked kernel family's (a name holding the mark), and the
    kernels that take the most."""
    busy = sum(k[0] for k in kernels) / 1e6
    if not busy:
        log(f"profile ({what}): wall {wall:.2f} s; device time not measured "
            "(the profiler recorded no CUDA kernels)")
        return
    gemm = sum(k[0] for k in kernels
               if any(m in k[2].lower() for m in GEMM_MARKS)) / 1e6
    shares = {mk: sum(k[0] for k in kernels if mk in k[2]) / 1e6 / busy
              for mk in marks}
    log(f"profile ({what}): wall {wall:.2f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of wall), {sum(k[1] for k in kernels)} "
        f"kernel launches; GEMMs {100 * gemm / busy:.1f}% of device time"
        + "".join(f", {mk} {100 * sh:.1f}%" for mk, sh in shares.items()))
    for us, n, name in sorted(kernels, reverse=True)[:12]:
        log(f"  {100 * us / 1e6 / busy:5.1f}% of device  {us / 1e3:9.2f} ms  "
            f"{n:7d} launches  {name[:100]}")


#: CUDA API calls (cuda* and cu*) that put kernels on the card: one a
#: kernel, or one a whole graph
KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def api_launches(torch, prof):
    """(kernel launch calls, graph launch calls) the host made in a
    profile (the CUDA API events CUPTI records), or None
    where the profile holds no runtime event."""
    calls = {e.key: e.count for e in prof.key_averages()
             if e.device_type != torch.autograd.DeviceType.CUDA}
    if not any(k.startswith(("cuda", "cu")) for k in calls):
        return None
    return (sum(calls.get(k, 0) for k in KERNEL_CALLS),
            sum(calls.get(k, 0) for k in GRAPH_CALLS))


def profile_phase(torch, sess, prompts, marks=(), **overrides):
    """One more drive of the same requests under ``torch.profiler`` (CUDA
    activity only, which keeps its overhead and post-processing small):
    wall time, the device's busy share (kernel time over wall), the share
    of device time of the GEMMs and of the kernels whose names hold one of
    ``marks``, and the kernels that take the most device time.  The drive
    reuses the warm engine of the kernels arm (of ``overrides``' arm):
    on the paged pool every prompt is a full prefix-cache hit and the
    profile is decode and verify; on the slotted pool (no prefix cache) it
    is the whole drive, prefills and decode.  Printed, and returned: wall,
    busy share, the host's kernel / graph launch calls, decode cycles and
    tok/s (new tokens over wall); nothing is asserted."""
    from torch.profiler import ProfilerActivity, profile
    marks_before = engine_marks(sess)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = sess.serve(prompts, max_new=MAX_NEW,
                          **{**DRIVE_KW.get(sess.model.name, {}),
                             **overrides})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    m = sess.engine.metrics.summary()
    dec = drive_decode(sess, marks_before)
    kernels = device_kernels(torch, prof)
    report_profile(kernels, wall,
                   f"warm engine, prefix-hit tokens "
                   f"{m['prefill_tokens_saved']}, decode_graphs="
                   f"{dec['decode_graphs']}, {dec['cycles']} decode cycles",
                   marks)
    api = api_launches(torch, prof)
    return {"wall": wall, "busy": sum(k[0] for k in kernels) / 1e6 / wall,
            "kernels": sum(k[1] for k in kernels), "api": api,
            "cycles": dec["cycles"],
            "tok_s": sum(len(o) for o in outs) / wall}


def graph_arms(torch, sess, prompts, graphed, marks, card):
    """qwen's decode graphs on the kernel drive's engine — graphs captured,
    their warm-up and capture seconds, the private pool's bytes — and the
    warm profile of the eager arm (the checked drive's engine: kernels on,
    ``decode_graphs=False``) beside the graph arm's ``graphed``."""
    g = sess.engine._graphs
    pool = g.pool_bytes()
    log(f"decode graphs ({sess.model.name}, kernels on): {len(g)} captured "
        f"({', '.join(map(str, g._graphs))}), warm-up + capture "
        f"{g.capture_s:.2f} s, private pool "
        + (f"{pool / 2**20:.1f} MiB" if pool is not None
           else "not measured") + f", {g.replays} replays so far [{card}]")
    eager = profile_phase(torch, sess, prompts, marks, use_kernels=True,
                          decode_graphs=False)
    for arm, r in (("graph", graphed), ("eager", eager)):
        api = ("not recorded" if r["api"] is None else
               f"{r['api'][0]} kernel + {r['api'][1]} graph launch calls = "
               f"{(r['api'][0] + r['api'][1]) / max(r['cycles'], 1):.1f} a "
               f"decode cycle over {r['cycles']} cycles (verify rows and "
               "copies included)")
        log(f"warm {sess.model.name} drive, {arm} arm [{card}]: wall "
            f"{r['wall']:.3f} s, device busy {100 * r['busy']:.1f}%, "
            f"{r['kernels']} kernels on the card; CUDA API: {api}; "
            f"{r['tok_s']:.1f} tok/s")


def _describe(cfg):
    if cfg.family == "hybrid":
        r = cfg.rglru
        return (f"RG-LRU width {r.lru_width}, conv {r.conv1d_width}, local "
                f"attention {cfg.num_heads}/{cfg.num_kv_heads} kv heads hd "
                f"{cfg.resolved_head_dim} window {r.attention_window}, d_ff "
                f"{cfg.d_ff}")
    if cfg.family == "ssm":
        return (f"{cfg.d_model // cfg.rwkv.head_size} WKV heads of "
                f"{cfg.rwkv.head_size}, decay LoRA {cfg.rwkv.decay_lora}, "
                f"d_ff {cfg.d_ff}")
    if cfg.attn_kind == "swa":
        e = cfg.moe
        return (f"heads {cfg.num_heads}/{cfg.num_kv_heads} kv, hd "
                f"{cfg.resolved_head_dim}, window {cfg.window}, "
                f"{e.num_experts} experts top-{e.top_k} (d_ff "
                f"{e.d_ff_expert})")
    if cfg.attn_kind == "mla":
        m, e = cfg.mla, cfg.moe
        return (f"heads {cfg.num_heads}, MLA kv_lora_rank {m.kv_lora_rank} "
                f"rope {m.qk_rope_head_dim} qk {m.qk_nope_head_dim}+"
                f"{m.qk_rope_head_dim} v {m.v_head_dim}, {e.num_experts} "
                f"experts top-{e.top_k} + {e.num_shared_experts} shared "
                f"(d_ff {e.d_ff_expert} / {e.d_ff_shared})")
    return (f"heads {cfg.num_heads}/{cfg.num_kv_heads} kv, hd "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}")


def load_for_serving(torch, arch, **overrides):
    """A seeded full-width session of ``arch`` with its weights made on
    the card, its six requests, and one warm-up serve (cuBLAS handles,
    allocator growth, first launches) on a one-request engine of its own,
    so the timed drives after it are steady."""
    from repro_torch import api
    t0 = time.perf_counter()
    sess = api.load(arch, device="cuda", seed=SEED,
                    **{**LOAD_KW.get(arch, {}), **overrides})
    cfg = sess.model
    cut = (f"depth cut to {cfg.num_layers} layers" if arch in LOAD_KW
           else "no depth cut")
    log(f"model {cfg.name} ({cfg.compute_dtype}): {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {_describe(cfg)}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.2f} B params ({cut})")
    torch.cuda.reset_peak_memory_stats()
    _ = sess.params                          # init on the card, timed apart
    torch.cuda.synchronize()
    log(f"weights: init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak")
    prompts = make_prompts(cfg.vocab_size, REPETITIVE[arch],
                           LONG_PROMPT.get(arch, 0))
    sess.serve([prompts[1][:8]], max_new=2)
    return sess, prompts


def check_paged_launches(cfg, counts, names, pool):
    """On the paged pool every layer of every decode step the card ran
    launches the decode kernel (``names[0]``: K1, K4, K6, or their int8
    branches) once — replays of a decode graph count its captured launches
    each time, and the steps include the graphs' warm-up runs
    (``DRIVE``) — and of every prefill chunk and verify the prefill kernel
    (``names[1]``) once; on ring pages the pool must have rotated a cell."""
    L = cfg.num_layers
    want = {names[0]: L * DRIVE["steps"],
            names[1]: L * (MODEL_CALLS.get("lm_paged_prefill", 0)
                           + MODEL_CALLS.get("lm_paged_verify", 0))}
    got = {n: counts[n] for n in names}
    ring = cfg.attn_kind == "swa"
    log(f"paged launches {got}: {L} layers x {DRIVE['steps']} decode steps "
        f"on the card ({DRIVE['cycles']} cycles, decode_graphs="
        f"{DRIVE['decode_graphs']}) and x prefill chunks + verifies "
        f"{ {k: v for k, v in MODEL_CALLS.items() if k != 'lm_paged_decode'} }"
        + (f"; ring cells rotated {pool.ring_rotations}" if ring else ""))
    if got != want or (ring and pool.ring_rotations <= 0):
        raise AssertionError(f"paged launches {got}, expected {want}" + (
            f"; rotations {pool.ring_rotations}" if ring else ""))


def serve_phase(torch, arch, profile_marks=(), card=""):
    """Serve ``arch`` at full width with the kernels; then once more with
    every launch of the family's kernels checked; then with
    ``use_kernels=False``; then a
    profile; then (per-head pages) the int8 arm; for qwen, last, the same
    requests on the slotted pool.  Returns the kernel drives' launch
    counts of the family's kernels."""
    sess, prompts = load_for_serving(torch, arch)
    cfg = sess.model
    ours = SERVE_KERNELS[arch]
    recurrent = sess.bundle.kv_layout is None
    if arch in COLD_PROFILE:
        # the first drive, cold, under the profiler: the long prompt's
        # chunks run through the prefill kernel here, not in the warm
        # profile (there it is a prefix hit)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs, wall, counts, m = serve_once(torch, sess, prompts)
        report_profile(device_kernels(torch, prof), wall,
                       f"cold engine, the first drive: ttft mean "
                       f"{m['ttft_mean_s']:.3f} s p99 {m['ttft_p99_s']:.3f} s, "
                       f"prefill chunks {MODEL_CALLS.get('lm_paged_prefill')}",
                       profile_marks)
    else:
        outs, wall, counts, m = serve_once(torch, sess, prompts)
    pool = "slotted" if recurrent else "paged"
    log(f"serve {cfg.name} (kernels, {pool} pool): {len(prompts)} requests "
        f"x {MAX_NEW} new tokens in "
        f"{wall:.2f} s; tok/s {m['tokens_per_sec']:.2f}; ttft mean "
        f"{m['ttft_mean_s']:.3f} s p99 {m['ttft_p99_s']:.3f} s; prefix-hit "
        f"tokens {m['prefill_tokens_saved']}; drafted {m['drafted_tokens']} "
        f"accepted {m['accepted_tokens']}; prefill shapes "
        f"{m['compile_count']}; launches {counts}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name in ours:
        if counts[name] <= 0:
            raise AssertionError(f"{name} kernel never launched on the main "
                                 "path")
    if recurrent:
        # every request prefills once, whole, at its exact length
        if m["preemptions"] or m["compile_count"] != len(
                {len(p) for p in prompts}):
            raise AssertionError(f"unexpected prefills: {m}")
        want = {n: k * len(prompts)
                for n, k in launches_per_prefill(cfg).items()}
        got = {n: c for n, c in counts.items() if c or n in want}
        if got != want:
            raise AssertionError(f"launches {got}, expected {want} "
                                 f"({len(prompts)} prefills)")
        log(f"launches per prefill {launches_per_prefill(cfg)} x "
            f"{len(prompts)} prefills: as expected")
    else:
        if m["prefill_tokens_saved"] <= 0:
            raise AssertionError("no prefix-cache hit on the main path")
        if m["drafted_tokens"] <= 0:
            raise AssertionError("no speculative drafts were verified")
    if not recurrent:
        check_paged_launches(cfg, counts, ours, sess.engine.pool)
    moe = cfg.moe is not None
    if moe:
        check_moe_launches(cfg, counts, "kernels")
    for o in outs:
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"bad stream {o}")
    checked_drive(torch, sess, prompts, outs, ours)

    plain, pwall, pcounts, pm = serve_once(torch, sess, prompts,
                                           use_kernels=False)
    log(f"serve {cfg.name} (plain, use_kernels=False): {pwall:.2f} s; tok/s "
        f"{pm['tokens_per_sec']:.2f}; ttft mean {pm['ttft_mean_s']:.3f} s; "
        f"launches {pcounts}")
    if any(plain_launches(pcounts).values()):
        raise AssertionError(f"plain arm launched kernels: {pcounts}")
    if moe:
        check_moe_launches(cfg, pcounts, "plain")
    # random-weight MoE and recurrent streams part far from bf16 near-ties
    # (see the fp32 arms), so there the partings are printed and the
    # kernels are held by the checked drive and the fp32 arms instead
    compare_streams(torch, sess, prompts, outs, plain,
                    asserted=not (moe or recurrent))
    graphed = profile_phase(torch, sess, prompts, profile_marks)
    if arch == "qwen2.5-14b":
        graph_arms(torch, sess, prompts, graphed, profile_marks, card)
    out = {n: counts[n] for n in ours + (("moe_grouped",) if moe else ())}
    if arch in INT8_SERVE_KERNELS:
        out.update(int8_arm(torch, sess, prompts, outs))
    if arch == "qwen2.5-14b":
        out["flash_attention"] = slotted_arm(torch, sess, prompts, outs)
        sampled_arm(torch, sess, prompts, card)
    return out


def int8_arm(torch, sess, prompts, outs):
    """The same requests on int8 pages (``kv_dtype="int8"``), kernels on:
    the K8 branches of the family's kernels must launch, and no fp page
    kernel; the page bytes against a bf16 page and the streams' partings
    from the bf16-page streams are printed (int8 pages are another
    function); then the checked drive on int8 pages holds every K8 launch
    against its plain version (the int8 kernel and plain arms share the
    fused dequant).  Returns the K8 launches."""
    cfg = sess.model
    names = INT8_SERVE_KERNELS[cfg.name]
    q8, wall, counts, m = serve_once(torch, sess, prompts, kv_dtype="int8")
    pool = sess.engine.pool
    bf16_page = pool.page_bytes_fp32 // 2          # bf16 data leaves
    log(f"serve {cfg.name} (kernels, int8 pages): {wall:.2f} s; tok/s "
        f"{m['tokens_per_sec']:.2f}; ttft mean {m['ttft_mean_s']:.3f} s; "
        f"prefix-hit tokens {m['prefill_tokens_saved']}; drafted "
        f"{m['drafted_tokens']}; launches {counts}; page bytes "
        f"{pool.page_bytes} vs {bf16_page} bf16 = "
        f"{pool.page_bytes / bf16_page:.4f}; kv bytes peak "
        f"{m['kv_bytes_peak']}")
    fp = [n for n in BY_PAGES if n not in INT8_KERNELS and counts[n]]
    if any(counts[n] <= 0 for n in names) or fp:
        raise AssertionError(f"int8 drive launches {counts}")
    check_paged_launches(cfg, counts, names, pool)
    parted = [next(k for k in range(len(a)) if a[k] != b[k])
              for a, b in zip(q8, outs) if a != b]
    log(f"int8 vs bf16 pages: {len(outs) - len(parted)}/{len(outs)} greedy "
        f"streams identical, the rest part at indices {parted} (printed, "
        "not asserted)")
    checked_drive(torch, sess, prompts, q8, names, kv_dtype="int8")
    return {n: counts[n] for n in names}


def slotted_arm(torch, sess, prompts, paged_outs):
    """The same requests on the slotted pool: bucketed whole-prompt
    prefill through K3 (hd 128), the batched decode of every slot at its
    own position (plain PyTorch attention).  K3 must run and no paged
    kernel; the streams' partings from the paged kernel arm (another
    attention kernel, another order of sums) are printed.  Returns K3's
    launches."""
    outs, wall, counts, m = serve_once(torch, sess, prompts,
                                       kv_layout="slotted")
    log(f"serve {sess.model.name} (kernels, slotted pool): {wall:.2f} s; "
        f"tok/s {m['tokens_per_sec']:.2f}; ttft mean {m['ttft_mean_s']:.3f} "
        f"s; prefill shapes {m['compile_count']}; launches {counts}")
    paged = [n for n in ("paged_attention", "paged_prefill") if counts[n]]
    if counts["flash_attention"] <= 0 or paged:
        raise AssertionError(f"slotted arm launches {counts}")
    for o in outs:
        if len(o) != MAX_NEW:
            raise AssertionError(f"bad stream {o}")
    same = sum(a == b for a, b in zip(outs, paged_outs))
    log(f"slotted vs paged kernel arms: {same}/{len(outs)} greedy streams "
        "identical (printed, not asserted)")
    return counts["flash_attention"]


# ---------------------------------------------------------------------------
# phase 6: train full-width qwen2.5-14b (4 layers) through Session.train
# ---------------------------------------------------------------------------

def _one_batch_dataset(vocab):
    """One seeded global batch of TRAIN_BATCH x TRAIN_SEQ tokens: every
    batch the pipeline draws is these rows, so training must lower the
    loss."""
    import numpy as np
    from repro_torch.data.readers import DataSet
    toks = np.random.default_rng(SEED + 3).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1), dtype=np.int32)
    return DataSet(training_data=toks[:, :-1], training_labels=toks[:, 1:])




def _k3_device_share(torch, sess, kw):
    """One more train step under the profiler (CUDA activity): K3's share
    of the step's device time, the GEMMs' share, and the busy share of the
    step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.train(1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    total = flash = gemm = 0.0
    top = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        if "flash_fwd_kernel" in e.key:
            flash += us
        elif any(m in e.key.lower() for m in GEMM_MARKS):
            gemm += us
        top.append((us, e.count, e.key))
    if not total:
        log("train profile: device time not measured (the profiler "
            "recorded no CUDA kernels)")
        return None
    log(f"train profile (one step): wall {wall:.3f} s, device busy "
        f"{total / 1e6:.3f} s ({100 * total / 1e6 / wall:.1f}% of wall); "
        f"K3 {flash / 1e3:.2f} ms = {100 * flash / total:.1f}% of device "
        f"time, GEMMs {gemm / 1e3:.2f} ms = {100 * gemm / total:.1f}%, the "
        f"rest (elementwise, reductions, copies, collectives) "
        f"{100 * (total - flash - gemm) / total:.1f}%")
    for us, n, name in sorted(top, reverse=True)[:10]:
        log(f"  {100 * us / total:5.1f}% of device  {us / 1e3:9.2f} ms  "
            f"{n:7d} launches  {name[:100]}")
    return flash / total


def train_arm(torch, card, use_kernels: bool):
    from repro_torch import api
    from repro_torch.kernels.flash_attention import kernel as fk
    t0 = time.perf_counter()
    sess = api.load("qwen2.5-14b", num_layers=TRAIN_LAYERS, device="cuda",
                    seed=SEED, allreduce="bucketed")
    cfg = sess.model
    ds = _one_batch_dataset(cfg.vocab_size)
    kw = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, lr=TRAIN_LR,
              data=ds, use_kernels=use_kernels)
    torch.cuda.reset_peak_memory_stats()
    fk.flash_attention_kernel.launches = 0
    first = sess.train(1, **kw)               # init + step 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rest = sess.train(TRAIN_STEPS - 1, **kw)  # the stream continues
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t1) / (TRAIN_STEPS - 1)
    launches = fk.flash_attention_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = first.losses + rest.losses
    arm = "kernels" if use_kernels else "plain"
    tok_s = TRAIN_BATCH * TRAIN_SEQ / steady
    log(f"train ({arm}, {cfg.name}: {cfg.num_layers} of 48 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.2f} B params, remat {cfg.remat}, "
        f"allreduce bucketed over a 1-rank NCCL group): {TRAIN_STEPS} steps "
        f"of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in "
        f"{time.perf_counter() - t0:.1f} s incl. init; step 1 loss "
        f"{losses[0]:.5f} grad_norm {first.metrics['grad_norm']:.5f}; "
        f"losses {[round(x, 5) for x in losses]}; steady step "
        f"{steady * 1e3:.1f} ms, {tok_s:.0f} tokens/s, peak {peak:.1f} GiB; "
        f"K3 launches {launches} [{card}]")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"bad loss curve {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arm} arm: the loss did not fall: {losses}")
    share = None
    if use_kernels:
        layer_passes = 2 if cfg.remat != "none" else 1
        want = TRAIN_STEPS * cfg.num_layers * layer_passes
        if launches != want:
            raise AssertionError(f"K3 launched {launches} times on the train "
                                 f"path, expected {want}")
        share = _k3_device_share(torch, sess, kw)
    elif launches:
        raise AssertionError(f"plain arm launched K3 {launches} times")
    out = dict(losses=losses, grad_norm1=first.metrics["grad_norm"],
               launches=launches, steady_s=steady, tok_s=tok_s, peak=peak,
               k3_share=share)
    del sess, first, rest
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_phase(torch, card):
    import torch.distributed as dist
    pg_file = ROOT / "build" / f"chip_smoke_pg_{os.getpid()}"
    pg_file.parent.mkdir(parents=True, exist_ok=True)
    pg_file.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{pg_file}",
                            world_size=1, rank=0)
    try:
        kern = train_arm(torch, card, use_kernels=True)
        plain = train_arm(torch, card, use_kernels=False)
        t0 = time.perf_counter()
        checkpoint_drive(torch, card)
        alexnet_drive(torch, card)
        kern["launches"] += family_train_drives(torch, card)
        log(f"train phase, added drives (checkpoint, AlexNet, TinyCNN, "
            f"deepseek / recurrentgemma / rwkv6 train): "
            f"{time.perf_counter() - t0:.1f} s wall [{card}]")
    finally:
        dist.destroy_process_group()
        pg_file.unlink(missing_ok=True)
    compare_train_arms("qwen2.5-14b", kern, plain, card)
    return kern


# ---------------------------------------------------------------------------
# phase 7: the paper's CNNs, the moe / hybrid / ssm families and
# checkpoint / resume, trained on the card (inside phase 6's process group)
# ---------------------------------------------------------------------------

#: the device of the drives below
DEVICE = "cuda"
#: AlexNet (the paper's Table II network) at full size: 227 x 227 x 3
#: images (the only size the reference's f6 takes), 1000 classes, fp32,
#: momentum; one seeded batch, repeated, so the loss must fall
ALEX_BATCH, ALEX_STEPS, ALEX_LR, ALEX_CHECK = 128, 6, 1e-2, 8
#: step-1 loss on the first ALEX_CHECK images, card against the CPU port
#: (TF32 off: the same fp32 ops, summed in other orders)
ALEX_LOSS_RTOL = 1e-4
#: TinyCNN (Fig. 7's network): its 6-step curve, card against CPU
TINY_ATOL = 1e-4
#: the moe, hybrid and ssm families at full width, cut in depth: (arch,
#: ``load`` overrides, what the cut keeps)
FAMILY_TRAIN = (
    ("deepseek-v2-lite-16b", {"num_layers": 2},
     "2 of 27 layers, both MoE"),
    ("recurrentgemma-2b", {"num_layers": 3},
     "one super-block (rec, rec, attn) of 26 layers"),
    ("rwkv6-1.6b", {"num_layers": 4}, "4 of 24 layers"))
FAMILY_STEPS, FAMILY_SEQ, FAMILY_BATCH = 3, 512, 2
#: checkpoint drive: recurrentgemma as its family drive cuts it (a
#: checkpoint of fp32 masters and Adam moments is 12 bytes a parameter:
#: 10.9 GB here, 32 GB for the 4-layer qwen drive, two saves of which
#: would nearly fill the card machine's 75 GB of free disk), and the
#: resumed losses 4-6 against the uninterrupted run's
CKPT_ARCH = FAMILY_TRAIN[1]
CKPT_RTOL = 1e-5


def alexnet_macs(hw=227):
    """Multiply-adds of one AlexNet forward per image (convolutions and
    dense layers; pools and ReLUs are not counted)."""
    def conv(h, k, s, cin, cout, pad):
        o = (h + 2 * pad - k) // s + 1
        return o, o * o * cout * k * k * cin
    h, c1 = conv(hw, 11, 4, 3, 96, 0)             # 55
    h = (h - 3) // 2 + 1                           # 27
    h, c2 = conv(h, 5, 1, 96, 256, 2)
    h = (h - 3) // 2 + 1                           # 13
    _, c3 = conv(h, 3, 1, 256, 384, 1)
    _, c4 = conv(h, 3, 1, 384, 384, 1)
    _, c5 = conv(h, 3, 1, 384, 256, 1)
    return c1 + c2 + c3 + c4 + c5 + 9216 * 4096 + 4096 * 4096 + 4096 * 1000


def step_profile(torch, step, what, marks=()):
    """One more training step (``step()``) under the profiler: the
    device's busy share of its wall time and where the device time goes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(device_kernels(torch, prof), wall, what, marks)


def _cnn_trainer(torch, arch, specs, forward, classes, batch, lr, device):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.core.transparent import TransparentTrainer
    from repro_torch.models import cnn
    run = RunConfig(model=get_config(arch),
                    shape=ShapeConfig(arch, "train", 0, batch),
                    mesh=MeshConfig(shape=(1, 1), axis_names=("data", "model")),
                    optimizer=OptimizerConfig(name="momentum", lr=lr))
    loss_fn = lambda p, b: cnn.cnn_loss(forward, p, b, classes)
    return TransparentTrainer(run, loss_fn, specs, device=device), loss_fn


def _image_batch(torch, n, hw, classes, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"images": torch.from_numpy(
        rng.normal(size=(n, hw, hw, 3)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, classes, (n,)))}


def alexnet_drive(torch, card):
    """AlexNet at full size through ``TransparentTrainer`` in the one-rank
    NCCL group: step-1 loss against the CPU port on the first images, 6
    steps on one repeated batch (the loss must fall), the steady step time
    against its operations bound, then TinyCNN's 6 steps against the CPU
    port's sequential steps."""
    from repro_torch.core.transparent import _value_and_grad
    from repro_torch.models import cnn
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.optim.optimizers import (clip_by_global_norm,
                                              make_optimizer)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn."
        f"allow_tf32={torch.backends.cudnn.allow_tf32}")
    specs = cnn.alexnet_specs(1000)
    params = init_params(specs, torch.Generator().manual_seed(SEED),
                         dtype=torch.float32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = _image_batch(torch, ALEX_BATCH, 227, 1000, SEED + 5)
    tr, loss_fn = _cnn_trainer(torch, "alexnet", specs, cnn.alexnet_forward,
                               1000, ALEX_BATCH, ALEX_LR, DEVICE)
    head = {k: v[:ALEX_CHECK] for k, v in batch.items()}
    with torch.no_grad():
        cpu_loss = float(loss_fn(params, head))
        card_loss = float(loss_fn(tree_map(lambda t: t.to(DEVICE), params),
                                  {k: v.to(DEVICE) for k, v in head.items()}))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    log(f"alexnet step-1 loss on the first {ALEX_CHECK} images: card "
        f"{card_loss:.6f}, CPU port {cpu_loss:.6f}, rel diff {rel:.3g} (tol "
        f"{ALEX_LOSS_RTOL:g})")
    if not rel <= ALEX_LOSS_RTOL:
        raise AssertionError("AlexNet's loss on the card is not the CPU "
                             "port's")
    torch.cuda.reset_peak_memory_stats()
    state = tr.init(params=params)
    b = {k: v.to(DEVICE) for k, v in batch.items()}
    losses, times = [], []
    for _ in range(ALEX_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = tr.step(state, b)
        losses.append(float(m["loss"]))         # waits for the step
        times.append(time.perf_counter() - t0)
    steady = sorted(times[1:])[len(times[1:]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = 3 * 2 * alexnet_macs() * ALEX_BATCH
    bound_ms = flops / FP32_FLOPS_PER_S * 1e3
    log(f"alexnet train (227x227x3, 1000 classes, {n_params} params, fp32 "
        f"masters and compute, momentum lr {ALEX_LR}, batch {ALEX_BATCH}, "
        f"1-rank NCCL group): losses {[round(x, 4) for x in losses]}; "
        f"step 1 {times[0] * 1e3:.1f} ms, steady step (median of steps "
        f"2-{ALEX_STEPS}) {steady * 1e3:.2f} ms = "
        f"{ALEX_BATCH / steady:.0f} images/s; operations bound "
        f"{bound_ms:.2f} ms ({flops / 1e12:.3f} TFLOP at 67 TFLOP/s fp32); "
        f"peak {peak:.2f} GiB [{card}]")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"AlexNet's loss did not fall: {losses}")
    step_profile(torch, lambda: tr.step(state, b), "alexnet train step")
    del state, b
    # TinyCNN (Fig. 7's network): the card's curve against the CPU port's
    tspecs = cnn.tinycnn_specs(10)
    tparams = init_params(tspecs, torch.Generator().manual_seed(SEED),
                          dtype=torch.float32)
    tb = _image_batch(torch, 8, 16, 10, SEED + 6)
    ttr, tloss = _cnn_trainer(torch, "tinycnn", tspecs, cnn.tinycnn_forward,
                              10, 8, 1e-2, DEVICE)
    st = ttr.init(params=tparams)
    bd = {k: v.to(DEVICE) for k, v in tb.items()}
    on_card = [float(ttr.step(st, bd)[1]["loss"])
               for _ in range(ALEX_STEPS)]
    # the CPU port's sequential step, as the trainer takes it with one
    # replica (no process group here: NCCL has no CPU backend)
    ocfg = ttr.run_cfg.optimizer
    opt = make_optimizer(ocfg)
    p = tree_map(lambda t: t.clone(), tparams)
    o, cpu = opt.init(p), []
    for _ in range(ALEX_STEPS):
        loss, g = _value_and_grad(tloss, p, tb)
        if ocfg.grad_clip:
            clip_by_global_norm(g, ocfg.grad_clip)
        p, o = opt.update(g, o, p)
        cpu.append(float(loss))
    gap = max(abs(a - c) for a, c in zip(on_card, cpu))
    log(f"tinycnn train (16x16x3, 10 classes, momentum lr 1e-2, batch 8): "
        f"card {[round(x, 5) for x in on_card]}, CPU port max diff "
        f"{gap:.3g} (tol {TINY_ATOL:g})")
    if not gap <= TINY_ATOL or not on_card[-1] < on_card[0]:
        raise AssertionError("TinyCNN on the card is not the CPU port's")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steady_s=steady, peak=peak, losses=losses)


def _token_batch_dataset(vocab, batch, seq, seed):
    import numpy as np
    from repro_torch.data.readers import DataSet
    toks = np.random.default_rng(seed).integers(
        0, vocab, (batch, seq + 1), dtype=np.int32)
    return DataSet(training_data=toks[:, :-1], training_labels=toks[:, 1:])


def train_k3_layers(cfg):
    """Attention layers whose training forward launches K3 (through the
    flash autograd Function): one in three of the hybrid family's, none
    of MLA's (expanded) or the ssm family's, whisper's encoder and
    decoder self-attention (its cross-attention trains plain)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // 3
    if cfg.attn_kind == "mla" or cfg.family == "ssm":
        return 0
    if cfg.encdec:
        return cfg.encdec.num_encoder_layers + cfg.num_layers
    return cfg.num_layers


def train_arm_run(torch, card, arch, cfg, step, steps, use_kernels, what):
    """One train arm: ``step(n)`` runs n steps and returns (their losses,
    the first one's grad norm).  1 step, then ``steps - 1`` (the stream
    continues); the loss must fall, and K3 alone runs, steps x
    ``train_k3_layers`` (x2 under remat) times on the kernel arm, never on
    the plain one; one more step profiled on the kernel arm."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses, gn1 = step(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = losses + step(steps - 1)[0]
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t1) / (steps - 1)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    arm = "kernels" if use_kernels else "plain"
    want = (steps * train_k3_layers(cfg) * (2 if cfg.remat != "none" else 1)
            if use_kernels else 0)
    log(f"{arch} train ({arm}; {what}, {cfg.param_count():,} params, remat "
        f"{cfg.remat}; {steps} steps, adam lr {TRAIN_LR}, 1-rank NCCL group)"
        f" in {time.perf_counter() - t0:.1f} s: losses "
        f"{[round(x, 5) for x in losses]}, step-1 grad norm {gn1:.5f}; "
        f"steady step {steady * 1e3:.1f} ms, peak {peak:.2f} GiB; K3 "
        f"launches {counts['flash_attention']} (expected {want}) [{card}]")
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{arch} ({arm}): bad loss curve {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} ({arm}): the loss did not fall")
    if counts["flash_attention"] != want or sum(counts.values()) != want:
        raise AssertionError(f"{arch} ({arm}): launches {counts}, K3 "
                             f"expected {want}")
    if use_kernels:
        step_profile(torch, lambda: step(1), f"{arch} train step",
                     ("flash_fwd_kernel",))
    return dict(losses=losses, grad_norm1=gn1, k3=counts["flash_attention"],
                steady_s=steady, peak=peak)


def compare_train_arms(arch, kern, plain, card):
    """The kernel and plain arms from one init agree at step 1: loss and
    grad norm within rel LOSS_RTOL / GNORM_RTOL."""
    l_err = abs(kern["losses"][0] - plain["losses"][0]) / abs(
        plain["losses"][0])
    g_err = abs(kern["grad_norm1"] - plain["grad_norm1"]) / abs(
        plain["grad_norm1"])
    log(f"{arch} train comparison: step-1 loss rel diff {l_err:.3g} (tol "
        f"{LOSS_RTOL:g}), grad-norm rel diff {g_err:.3g} (tol "
        f"{GNORM_RTOL:g}); steady step kernels {kern['steady_s'] * 1e3:.1f} "
        f"ms vs plain {plain['steady_s'] * 1e3:.1f} ms [{card}]")
    if l_err > LOSS_RTOL or g_err > GNORM_RTOL:
        raise AssertionError(f"{arch}: the train arms disagree at step 1")


def family_train_arm(torch, card, arch, overrides, cut, use_kernels):
    """``Session.train`` of one family cut in depth, FAMILY_STEPS steps on
    one repeated batch."""
    from repro_torch import api
    sess = api.load(arch, device=DEVICE, seed=SEED, **overrides)
    cfg = sess.model
    ds = _token_batch_dataset(cfg.vocab_size, FAMILY_BATCH, FAMILY_SEQ,
                              SEED + 7)
    kw = dict(seq_len=FAMILY_SEQ, global_batch=FAMILY_BATCH, lr=TRAIN_LR,
              data=ds, use_kernels=use_kernels)

    def step(n):                          # the first call inits the params
        r = sess.train(n, **kw)
        return r.losses, r.metrics["grad_norm"]

    out = train_arm_run(torch, card, arch, cfg, step, FAMILY_STEPS,
                        use_kernels, f"full width, {cut}: {_describe(cfg)}; "
                        f"batch {FAMILY_BATCH}x{FAMILY_SEQ} tokens")
    del sess, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_train_drives(torch, card):
    """Each family from one init with kernels; where that arm launched K3
    (recurrentgemma), again with ``use_kernels=False``: step-1 loss and
    grad norm agree (the qwen drive's limits), both losses fall.  deepseek
    (expanded MLA) and rwkv6 (the ``wkv_scan`` loop) train through no
    kernel, so their plain arm would run the same code."""
    k3 = 0
    for arch, overrides, cut in FAMILY_TRAIN:
        kern = family_train_arm(torch, card, arch, overrides, cut, True)
        k3 += kern["k3"]
        if not kern["k3"]:
            continue
        plain = family_train_arm(torch, card, arch, overrides, cut, False)
        compare_train_arms(arch, kern, plain, card)
    return k3


def checkpoint_drive(torch, card):
    """``CKPT_ARCH`` cut as its family drive: an uninterrupted ``train(6)``;
    then ``train(3, ckpt_dir, ckpt_every=3)`` (an async save at step 3);
    then a new Session's ``train(3, ckpt_dir, resume=True)`` (restore, 3
    steps, a blocking save at step 6), whose losses must equal steps 4-6
    of the uninterrupted run.  The data set is one token row repeated
    FAMILY_BATCH times: the pipeline shuffles rows anew each epoch, and
    another row order sums the weight gradients in another order, which
    training amplifies (rwkv6's 2-row batch parted by 4.7e-4 at step 5);
    with equal rows every epoch feeds the same batch, so the resumed
    stream's restart does not matter."""
    import shutil
    import numpy as np
    from repro_torch import api
    from repro_torch.data.readers import DataSet
    arch, overrides, cut = CKPT_ARCH
    ckpt = ROOT / "build" / f"chip_smoke_ckpt_{os.getpid()}"
    shutil.rmtree(ckpt, ignore_errors=True)

    def session():
        gc.collect()
        torch.cuda.empty_cache()
        return api.load(arch, device=DEVICE, seed=SEED, **overrides)
    try:
        sess = session()
        row = _token_batch_dataset(sess.model.vocab_size, 1, FAMILY_SEQ,
                                   SEED + 7)
        ds = DataSet(training_data=np.repeat(row.training_data, FAMILY_BATCH,
                                             axis=0),
                     training_labels=np.repeat(row.training_labels,
                                               FAMILY_BATCH, axis=0))
        kw = dict(seq_len=FAMILY_SEQ, global_batch=FAMILY_BATCH, lr=TRAIN_LR,
                  data=ds, use_kernels=True)
        whole = sess.train(6, **kw).losses
        del sess
        sess = session()
        t0 = time.perf_counter()
        first = sess.train(3, ckpt_dir=str(ckpt), ckpt_every=3, **kw)
        t_first = time.perf_counter() - t0
        (a,) = first.saves
        del sess
        sess = session()
        t0 = time.perf_counter()
        second = sess.train(3, ckpt_dir=str(ckpt), resume=True, **kw)
        t_second = time.perf_counter() - t0
        (b,) = second.saves
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rel = max(abs(x - y) / abs(y)
              for x, y in zip(first.losses + second.losses, whole))
    log(f"checkpoint ({arch}, {cut}): train(3, ckpt_every=3) {t_first:.1f} s"
        f"; async save at step {a.step}: {a.bytes / 1e9:.3f} GB, "
        f"device-to-host {a.copy_s:.2f} s on the caller's thread, file I/O "
        f"{a.write_s:.2f} s on its own; resumed train(3) {t_second:.1f} s "
        f"incl. restore; blocking save at step {b.step}: "
        f"{b.bytes / 1e9:.3f} GB, device-to-host {b.copy_s:.2f} s + file "
        f"I/O {b.write_s:.2f} s; losses {[round(x, 6) for x in first.losses]}"
        f" + {[round(x, 6) for x in second.losses]} vs uninterrupted "
        f"{[round(x, 6) for x in whole]}: max rel diff {rel:.3g} (tol "
        f"{CKPT_RTOL:g}) [{card}]")
    if second.step != 6 or not rel <= CKPT_RTOL:
        raise AssertionError("the resumed run left the uninterrupted curve")


# ---------------------------------------------------------------------------
# phase 8: deepseek in fp32, kernels on and off, teacher-forced logits
# ---------------------------------------------------------------------------

#: fp32 arms: the largest |kernel path - plain path| difference of the
#: teacher-forced logits (about 5 in size) allowed; both paths sum fp32
#: terms in other orders through every layer (27 deepseek, 26
#: recurrentgemma, 24 rwkv6)
FP32_LOGIT_ATOL = 1e-3


def teacher_forced_logits(torch, sess, seq, n_prompt, use_kernels):
    """Logits (fp32) of the serving path along ``seq``.  Paged families, on
    pages of their own: the first ``n_prompt`` tokens as chunked prefill
    (the drive's chunks; K7 / K5, or their plain paths without kernels),
    then one ``lm_paged_decode`` step per further token (K6 / K4, or their
    plain versions).
    Recurrent families: the whole-prompt prefill (K3 / K9 / K10, or their
    plain versions), then one ``decode_fn`` step per further token.  Row r
    predicts ``seq[n_prompt + r]``."""
    from repro_torch.models import transformer
    cfg, dev, params = sess.model, sess.device, sess.params
    b = sess.bundle
    if b.kv_layout is None:
        with torch.no_grad():
            first, state = b.serve_prefill_fn(
                params, torch.tensor([seq[:n_prompt]], device=dev),
                cache_len=len(seq), use_kernels=use_kernels)
            rows = [first[0]]
            for p in range(n_prompt, len(seq) - 1):
                logits, state = b.decode_fn(
                    params, torch.tensor([[seq[p]]], device=dev), state)
                rows.append(logits[0])
        return torch.stack(rows).float()
    layout = sess.bundle.kv_layout
    n = layout.table_width(-(-len(seq) // PS), PS)   # a ring: its cells
    blank = transformer.init_decode_caches(cfg, 1, PS, device=dev)
    pages = {k: torch.zeros((cfg.num_layers, n + 1) + blank[k].shape[2:],
                            dtype=blank[k].dtype, device=dev)
             for k in layout.leaves}
    table = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    # the prompt in the drive's chunks (a ring's chunk fits its window)
    step = DRIVE_KW.get(cfg.name, {}).get("prefill_chunk_tokens") or n_prompt
    with torch.no_grad():
        for start in range(0, n_prompt, step):
            chunk = seq[start:min(start + step, n_prompt)]
            state = {"pages": pages, "page_table": table, "start": start,
                     "n_valid": len(chunk)}
            first, _ = transformer.lm_paged_prefill(
                cfg, params, torch.tensor([chunk], device=dev), state,
                use_kernels=use_kernels)
        rows = [first[0]]
        for p in range(n_prompt, len(seq) - 1):
            state = {"pages": pages, "page_table": table[None],
                     "pos": torch.tensor([p], dtype=torch.int32, device=dev)}
            logits, _ = transformer.lm_paged_decode(
                cfg, params, torch.tensor([[seq[p]]], device=dev), state,
                use_kernels=use_kernels)
            rows.append(logits[0])
    return torch.stack(rows).float()


#: a layer whose carried difference grows more than this over the layer
#: before is where the rwkv6 fp32 arm's logits gap is amplified
AMPLIFY = 10.0


def rwkv_layer_diff(torch, sess, seq):
    """rwkv6 in fp32: ``seq`` as one whole-sequence forward through both
    paths (K10 and the plain recurrence), each carrying its own hidden
    state.  Per layer: the carried difference of the layer outputs, and on
    the plain path's own layer input the kernel's WKV difference, the
    time-mix output's (after the per-head group norm and the output
    projection) and their ratio; then the logits'.  Prints the first layer
    whose carried difference grows more than ``AMPLIFY`` x and, for it,
    the difference op by op when both paths' inputs to it go through the
    plain path; then the logits' difference when the plain path runs with
    every layer's WKV output perturbed by Gaussian noise of the kernel's
    RMS difference there (the model's own gain, three seeds)."""
    from repro_torch.models import rwkv6 as rw
    from repro_torch.models.common import cast_tree, stack_slice
    from repro_torch.models.transformer import embed_lookup, lm_head
    cfg = sess.model
    params = cast_tree(sess.params, cfg.compute_dtype)
    wkv = rw.wkv_scan
    seen = []

    def recorded(*a, **kw):
        out = wkv(*a, **kw)
        seen.append((a, out[0]))
        return out

    def layer(lp, x, use_kernels):
        x, _ = rw.time_mix_apply(cfg, lp["tm"], x, use_kernels=use_kernels)
        tm = x
        x, _ = rw.channel_mix_apply(cfg, lp["cm"], x)
        return tm, x

    def dmax(a, b):
        return (a.float() - b.float()).abs().max().item()

    rw.wkv_scan = recorded
    try:
        with torch.no_grad():
            tokens = torch.tensor([seq], device=sess.device)
            xk = xp = embed_lookup(cfg, params, tokens, torch.float32)
            prev, first, gain, inputs, local = None, None, 0.0, [], []
            for i in range(cfg.num_layers):
                lp = stack_slice(params["layers"], i)
                inputs.append((xp, xk))
                seen.clear()
                tm_p, out_p = layer(lp, xp, False)
                tm_l, _ = layer(lp, xp, True)     # K10 on the plain input
                _, xk = layer(lp, xk, True)
                d_wkv, d_tm = dmax(seen[1][1], seen[0][1]), dmax(tm_l, tm_p)
                local.append((seen[1][1] - seen[0][1]).pow(2).mean().sqrt())
                carried = dmax(xk, out_p)
                gain = max(gain, d_tm / max(d_wkv, 1e-30))
                log(f"rwkv6 fp32 layer {i}: carried |kernel - plain| "
                    f"{carried:.3g} (|x| <= {out_p.abs().max().item():.3g});"
                    f" on the plain input: WKV {d_wkv:.3g}, time-mix "
                    f"{d_tm:.3g} ({d_tm / max(d_wkv, 1e-30):.3g}x)")
                if (first is None and prev is not None and prev > 0
                        and carried > AMPLIFY * prev):
                    first = (i, carried / prev)
                prev, xp = carried, out_p
            lk = lm_head(cfg, params, rw.apply_norm(
                cfg, params["final_norm"], xk))
            lpl = lm_head(cfg, params, rw.apply_norm(
                cfg, params["final_norm"], xp))
            if first is not None:
                # the amplifying layer op by op: both paths' inputs to it
                # through the plain path, the WKV's operands and output,
                # the time-mix output and the layer's
                i = first[0]
                lp = stack_slice(params["layers"], i)
                seen.clear()
                (tm_a, out_a), (tm_b, out_b) = (
                    layer(lp, x, False) for x in inputs[i])
                (ra, ka, va, wa, _), (rb, kb, vb, wb, _) = (
                    a for a, _ in seen)
                log(f"rwkv6 fp32 layer {i} op by op on the two paths' "
                    f"inputs (plain path): input "
                    f"{dmax(*inputs[i]):.3g}; r {dmax(ra, rb):.3g}, k "
                    f"{dmax(ka, kb):.3g}, v {dmax(va, vb):.3g}, decay w "
                    f"{dmax(wa, wb):.3g} (w <= {wa.max().item():.6f}); WKV "
                    f"out {dmax(seen[0][1], seen[1][1]):.3g} (|out| <= "
                    f"{seen[0][1].abs().max().item():.3g}); time-mix "
                    f"{dmax(tm_a - inputs[i][0], tm_b - inputs[i][1]):.3g}; "
                    f"layer {dmax(out_a, out_b):.3g}")
            # the model's own gain: the plain path with every layer's WKV
            # output perturbed by Gaussian noise of the kernel's RMS
            # difference there
            noisy = []
            for seed in range(3):
                gen = torch.Generator(device=sess.device).manual_seed(seed)
                size = iter(local)

                def perturbed(*a, **kw):
                    out, st = wkv(*a, **kw)
                    return out + next(size) * torch.randn(
                        out.shape, generator=gen, device=out.device), st
                rw.wkv_scan = perturbed
                x = inputs[0][0]
                for i in range(cfg.num_layers):
                    x = layer(stack_slice(params["layers"], i), x, False)[1]
                noisy.append(dmax(lm_head(cfg, params, rw.apply_norm(
                    cfg, params["final_norm"], x)), lpl))
    finally:
        rw.wkv_scan = wkv
    log(f"rwkv6 fp32 layer diff over {len(seq)} tokens: logits "
        f"|kernel - plain| {dmax(lk, lpl):.3g}; first layer whose carried "
        f"difference grows > {AMPLIFY:g}x: "
        + (f"{first[0]} ({first[1]:.3g}x)" if first else "none")
        + f"; largest time-mix / WKV difference ratio {gain:.3g}; the plain "
        f"path with its WKV outputs perturbed by Gaussian noise of the "
        f"kernel's RMS difference (RMS {min(local):.3g}-{max(local):.3g}; "
        f"seeds 0-2): logits differ by "
        + ", ".join(f"{d:.3g}" for d in noisy))


def fp32_phase(torch, arch="deepseek-v2-lite-16b"):
    """``arch`` at full width in fp32: the kernel arm and the plain arm
    (``use_kernels=False``) serve the six requests, and each request's
    prompt plus the kernel arm's stream is teacher-forced through both
    paths.  The logits must agree within FP32_LOGIT_ATOL, and a parting
    of the streams is accepted only where the plain path's logit of the
    kernel arm's token lies within 2 x FP32_LOGIT_ATOL of its top."""
    sess, prompts = load_for_serving(torch, arch, compute_dtype="float32")
    ours = SERVE_KERNELS[arch]
    outs, wall, counts, m = serve_once(torch, sess, prompts)
    plain, pwall, pcounts, _ = serve_once(torch, sess, prompts,
                                          use_kernels=False)
    log(f"serve {arch} fp32: kernels {wall:.2f} s (tok/s "
        f"{m['tokens_per_sec']:.2f}, drafted {m['drafted_tokens']} accepted "
        f"{m['accepted_tokens']}, launches {counts}), plain {pwall:.2f} s "
        f"(launches {pcounts}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(counts[n] > 0 for n in ours) or any(
            plain_launches(pcounts).values()):
        raise AssertionError(f"fp32 arms: launches {counts} / {pcounts}")
    identical, worst, t0 = 0, 0.0, time.perf_counter()
    for i, (p, a, b) in enumerate(zip(prompts, outs, plain)):
        seq = list(p) + list(a)
        lk = teacher_forced_logits(torch, sess, seq, len(p), True)
        lp = teacher_forced_logits(torch, sess, seq, len(p), False)
        d = (lk - lp).abs().max().item()
        worst = max(worst, d)
        agree = sum(int(t) == x for t, x in zip(lk.argmax(-1).tolist(), a))
        log(f"request {i} fp32: teacher-forced logits, max |kernel - plain| "
            f"{d:.3g} over {len(a)} positions (|logit| <= "
            f"{lp.abs().max().item():.3g}); kernel-path argmax equals the "
            f"kernel arm's token at {agree}/{len(a)}")
        if a == b:
            identical += 1
            continue
        j = next(k for k in range(len(a)) if a[k] != b[k])
        gap = (lp[j].max() - lp[j, a[j]]).item()
        log(f"request {i} fp32: streams part at index {j} ({a[j]} vs "
            f"{b[j]}); plain logit of the kernel arm's token {gap:.3g} below "
            f"its top (tol {2 * FP32_LOGIT_ATOL:.3g})")
        if gap > 2 * FP32_LOGIT_ATOL:
            raise AssertionError(f"fp32 request {i} diverges at {j}: {gap}")
    log(f"fp32 comparison ({arch}): {identical}/{len(outs)} greedy streams "
        f"identical; teacher-forced logits differ by at most {worst:.3g} "
        f"(tol {FP32_LOGIT_ATOL:.3g}); {time.perf_counter() - t0:.1f} s")
    if arch == "rwkv6-1.6b":
        rwkv_layer_diff(torch, sess, max((list(p) + list(a) for p, a in
                                          zip(prompts, outs)), key=len))
    if worst > FP32_LOGIT_ATOL:
        raise AssertionError(f"fp32 kernel and plain paths disagree: {worst}")
    del sess
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the encdec (whisper) and vlm (pixtral) families through the
# registry, and the serve launcher
# ---------------------------------------------------------------------------

#: whisper-tiny at full config: 4 requests of seeded frames [4, 1500, 384]
#: and a 16-token prompt, 32 greedy steps; training 6 steps of one
#: repeated batch of 8 x 448 target tokens
WHISPER, W_BATCH, W_TEXT, W_STEPS = "whisper-tiny", 4, 16, 32
W_TRAIN_STEPS, W_TRAIN_BATCH, W_TRAIN_TEXT = 6, 8, 448
#: pixtral-12b at full width and depth: 2 requests of 1,024 seeded patch
#: embeddings and 32 text tokens, 16 greedy steps; its fp32 arm cut to 8
#: layers (14 GB); training cut to 2 layers (1.91 B params, 30.6 GB of
#: fp32 masters, gradients and Adam moments), 512 text tokens, batch 2,
#: 3 steps
PIXTRAL, P_BATCH, P_TEXT, P_STEPS = "pixtral-12b", 2, 32, 16
P_FP32_LAYERS = 8
P_TRAIN_LAYERS, P_TRAIN_STEPS, P_TRAIN_BATCH, P_TRAIN_TEXT = 2, 3, 2, 512
#: the launcher's drive on the card: the full config (the smoke configs'
#: head_dim 16 is not one the CUDA kernels take, and the wrappers raise)
LAUNCHER = ["-m", "repro_torch.launch.serve", "--arch", "qwen2.5-14b",
            "--requests", "8"]


def modal_batch(torch, cfg, batch, n_text, seed):
    """Seeded tokens, next-token labels and the family's modality input
    (frames [B, T_enc, d] or patches [B, n_img, d], fp32) on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, n_text + 1),
                         generator=gen, device=DEVICE)
    if cfg.family == "encdec":
        key, n = "frames", cfg.encdec.encoder_seq_len
    else:
        key, n = "patches", cfg.vlm.num_image_tokens
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            key: torch.randn((batch, n, cfg.d_model), generator=gen,
                             device=DEVICE)}


def modal_stream(torch, sess, batch, steps, use_kernels, force=None):
    """The bundle's prefill over the batch, then ``steps`` decode steps
    fed the greedy tokens (or ``force`` [B, steps + 1]'s): (tokens [B,
    steps + 1], fp32 logits [B, steps + 1, V]).  Row i of the logits
    predicts token i."""
    cfg, b = sess.model, sess.bundle
    args = ((batch["frames"], batch["tokens"]) if cfg.family == "encdec"
            else (batch["tokens"], batch["patches"]))
    # whisper's decode runs its cross-attention through K3; pixtral's is
    # the dense lm_decode, which runs no kernel
    dkw = {"use_kernels": use_kernels} if cfg.family == "encdec" else {}
    with torch.no_grad():
        logits, state = b.prefill_fn(sess.params, *args,
                                     use_kernels=use_kernels)
        rows, toks = [logits.float()], [logits.argmax(-1)]
        for i in range(steps):
            feed = toks[-1] if force is None else force[:, i]
            logits, state = b.decode_fn(sess.params, feed[:, None], state,
                                        **dkw)
            rows.append(logits.float())
            toks.append(logits.argmax(-1))
    return torch.stack(toks, 1), torch.stack(rows, 1)


def modal_k3_launches(cfg, steps):
    """K3 in one prefill and ``steps`` decode steps: whisper's encoder
    layers, decoder self- and cross-attention in prefill, and the cross-
    attention of every decode step; pixtral one a layer in prefill."""
    if cfg.family == "encdec":
        return cfg.encdec.num_encoder_layers + cfg.num_layers * (2 + steps)
    return cfg.num_layers


def modal_load(torch, arch, **overrides):
    from repro_torch import api
    t0 = time.perf_counter()
    sess = api.load(arch, device=DEVICE, seed=SEED, **overrides)
    cfg = sess.model
    torch.cuda.reset_peak_memory_stats()
    _ = sess.params                          # init on the card, timed apart
    torch.cuda.synchronize()
    enc = (f"encoder {cfg.encdec.num_encoder_layers} layers over "
           f"{cfg.encdec.encoder_seq_len} frames, " if cfg.encdec else
           f"{cfg.vlm.num_image_tokens} image tokens, ")
    log(f"model {cfg.name} ({cfg.compute_dtype}): {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {enc}{_describe(cfg)}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count():,} params; weights: init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
    return sess


def modal_partings(torch, toks, other, logits, tol, what):
    """Rows where ``other``'s stream parts from ``toks``'s: at the first
    parting index, ``logits`` [B, n, V] (the other arm's own, or the plain
    path teacher-forced along ``toks``) must hold ``toks``'s token within
    ``tol(top logit)`` of its top.  Returns the identical rows' count."""
    identical = 0
    for r in range(toks.shape[0]):
        diff = (toks[r] != other[r]).nonzero()
        if not len(diff):
            identical += 1
            continue
        j = int(diff[0])
        row = logits[r, j]
        gap = (row.max() - row[toks[r, j]]).item()
        log(f"{what} request {r}: streams part at index {j} "
            f"({int(toks[r, j])} vs {int(other[r, j])}); logit gap {gap:.4g} "
            f"(tolerance {tol(row.max().item()):.4g})")
        if gap > tol(row.max().item()):
            raise AssertionError(f"{what} request {r} diverges at {j}")
    log(f"{what}: {identical}/{toks.shape[0]} greedy streams identical, the "
        "rest part only at near-ties")
    return identical


def modal_serve(torch, card, arch, batch_size, n_text, steps, *, plain_arm,
                **overrides):
    """One family's serve drive at the session's width: K3 counted over
    the kernel arm (zeroed just before, read just after), the drive again
    with every K3 launch held against its plain version on that launch's
    inputs, a profile of the drive, and (``plain_arm``) the
    ``use_kernels=False`` arm, whose streams may part only at bf16
    near-ties.  Returns (session, batch, tokens, K3 launches)."""
    sess = modal_load(torch, arch, **overrides)
    cfg = sess.model
    batch = modal_batch(torch, cfg, batch_size, n_text, SEED + 11)
    modal_stream(torch, sess, batch, 1, True)          # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = modal_stream(torch, sess, batch, steps, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = modal_k3_launches(cfg, steps)
    n_tok = batch_size * (steps + 1)
    log(f"serve {cfg.name} (kernels; bundle prefill_fn / decode_fn): "
        f"{batch_size} requests of {n_text} tokens"
        f"{' + frames' if cfg.encdec else ' + patches'}, {steps} greedy "
        f"steps in {wall:.3f} s ({n_tok / wall:.1f} tok/s); launches "
        f"{ {n: c for n, c in counts.items() if c} }, K3 expected {want}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if counts["flash_attention"] != want or sum(counts.values()) != want:
        raise AssertionError(f"{arch}: launches {counts}, K3 expected {want}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: token ids out of range")
    with checked_launches(torch, ["flash_attention"]) as errs:
        t0 = time.perf_counter()
        checked, _ = modal_stream(torch, sess, batch, steps, True)
        cwall = time.perf_counter() - t0
    report_checked(torch, errs, cwall)
    if len(errs["flash_attention"]) != want:
        raise AssertionError(f"checked run: {len(errs['flash_attention'])} "
                             f"K3 launches, expected {want}")
    log(f"checked run: greedy streams "
        f"{'equal' if torch.equal(checked, toks) else 'differ from'} the "
        f"kernel arm's")
    step_profile(torch, lambda: modal_stream(torch, sess, batch, steps, True),
                 f"{arch} serve drive, warm", ("flash_fwd_kernel",))
    if plain_arm:
        reset_counts()
        t0 = time.perf_counter()
        ptoks, plogits = modal_stream(torch, sess, batch, steps, False)
        torch.cuda.synchronize()
        pcounts = read_counts()
        log(f"serve {cfg.name} (plain, use_kernels=False): "
            f"{time.perf_counter() - t0:.3f} s; launches "
            f"{ {n: c for n, c in pcounts.items() if c} }")
        if any(pcounts.values()):
            raise AssertionError(f"plain arm launched kernels: {pcounts}")
        modal_partings(torch, toks, ptoks, plogits, bf16_tie,
                       f"{arch} kernel vs plain arm (bf16)")
    return sess, batch, toks, counts["flash_attention"]


def modal_fp32(torch, card, arch, batch_size, n_text, steps, **overrides):
    """``arch`` in fp32, kernels on and off: the plain path teacher-forced
    along the kernel arm's streams gives logits within FP32_LOGIT_ATOL of
    the kernel path's; the plain arm's own greedy streams part from the
    kernel arm's only where the plain path holds the kernel arm's token
    within 2 x FP32_LOGIT_ATOL of its top."""
    sess = modal_load(torch, arch, compute_dtype="float32", **overrides)
    batch = modal_batch(torch, sess.model, batch_size, n_text, SEED + 11)
    reset_counts()
    toks, lk = modal_stream(torch, sess, batch, steps, True)
    torch.cuda.synchronize()
    k3 = read_counts()["flash_attention"]
    _, lp = modal_stream(torch, sess, batch, steps, False, force=toks)
    ptoks, _ = modal_stream(torch, sess, batch, steps, False)
    d = (lk - lp).abs().max().item()
    log(f"{arch} fp32 ({sess.model.num_layers} layers; K3 launches {k3}): "
        f"teacher-forced logits, max |kernel - plain| {d:.3g} over "
        f"{batch_size} x {steps + 1} positions (|logit| <= "
        f"{lp.abs().max().item():.3g}; tol {FP32_LOGIT_ATOL:g}) [{card}]")
    if k3 != modal_k3_launches(sess.model, steps):
        raise AssertionError(f"{arch} fp32: K3 launched {k3} times")
    modal_partings(torch, toks, ptoks, lp, lambda _: 2 * FP32_LOGIT_ATOL,
                   f"{arch} fp32 kernel vs plain arm")
    if d > FP32_LOGIT_ATOL:
        raise AssertionError(f"{arch} fp32: kernel and plain paths disagree: "
                             f"{d}")
    del sess
    gc.collect()
    torch.cuda.empty_cache()


def modal_train_arm(torch, card, arch, overrides, batch_size, n_text, steps,
                    use_kernels):
    """``TransparentTrainer.from_bundle`` (adam, in the one-rank NCCL
    group) on one repeated batch that carries the family's frames /
    patches (``Session.train``'s synthetic data carries tokens only)."""
    from repro_torch import api
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.core.transparent import TransparentTrainer
    bundle = api.load(arch, device=DEVICE, seed=SEED, **overrides).bundle
    cfg = bundle.cfg
    run = RunConfig(model=cfg, shape=ShapeConfig(arch, "train", n_text,
                                                 batch_size),
                    mesh=MeshConfig(shape=(1, 1),
                                    axis_names=("data", "model")),
                    optimizer=OptimizerConfig(name="adam", lr=TRAIN_LR),
                    seed=SEED)
    tr = TransparentTrainer.from_bundle(run, bundle, device=DEVICE,
                                        use_kernels=use_kernels)
    held = {"state": tr.init(SEED)}
    batch = modal_batch(torch, cfg, batch_size, n_text, SEED + 13)

    def step(n):
        losses, gn1 = [], None
        for _ in range(n):
            held["state"], m = tr.step(held["state"], batch)
            losses.append(float(m["loss"]))
            gn1 = float(m["grad_norm"]) if gn1 is None else gn1
        return losses, gn1

    out = train_arm_run(torch, card, arch, cfg, step, steps, use_kernels,
                        f"{cfg.num_layers} decoder layers; batch "
                        f"{batch_size} x {n_text} text tokens")
    del tr, held, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def modal_train(torch, card, arch, overrides, batch_size, n_text, steps):
    """The kernel and plain arms from one init, compared at step 1.
    Returns the kernel arm's K3 launches."""
    kern = modal_train_arm(torch, card, arch, overrides, batch_size, n_text,
                           steps, True)
    plain = modal_train_arm(torch, card, arch, overrides, batch_size, n_text,
                            steps, False)
    compare_train_arms(arch, kern, plain, card)
    return kern["k3"]


def launcher_drive(card):
    """``python -m repro_torch.launch.serve`` as a user runs it on the
    card: it must exit 0 having served every request."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, *LAUNCHER], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    for line in (r.stdout + r.stderr).strip().splitlines()[-14:]:
        log(f"  | {line}")
    log(f"launcher: python {' '.join(LAUNCHER)} -> rc {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    if r.returncode != 0 or "served 8/8 requests" not in r.stdout:
        raise AssertionError(f"the serve launcher failed: rc {r.returncode}")


def encdec_vlm_phase(torch, card):
    """whisper-tiny at full config and pixtral-12b at full width and depth
    through the registry bundles (serve: prefill_fn / decode_fn; train:
    ``TransparentTrainer.from_bundle`` in a one-rank NCCL group), their
    fp32 arms, then the serve launcher.  Returns K3's launches on these
    drives (the kernel arms' serve and train runs)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    sess, _, _, k3 = modal_serve(torch, card, WHISPER, W_BATCH, W_TEXT,
                                 W_STEPS, plain_arm=False)
    del sess
    modal_fp32(torch, card, WHISPER, W_BATCH, W_TEXT, W_STEPS)
    sess, _, _, n = modal_serve(torch, card, PIXTRAL, P_BATCH, P_TEXT,
                                P_STEPS, plain_arm=True)
    k3 += n
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    modal_fp32(torch, card, PIXTRAL, P_BATCH, P_TEXT, P_STEPS,
               num_layers=P_FP32_LAYERS)
    pg_file = ROOT / "build" / f"chip_smoke_pg_modal_{os.getpid()}"
    pg_file.parent.mkdir(parents=True, exist_ok=True)
    pg_file.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{pg_file}",
                            world_size=1, rank=0)
    try:
        k3 += modal_train(torch, card, WHISPER, {}, W_TRAIN_BATCH,
                          W_TRAIN_TEXT, W_TRAIN_STEPS)
        k3 += modal_train(torch, card, PIXTRAL,
                          {"num_layers": P_TRAIN_LAYERS}, P_TRAIN_BATCH,
                          P_TRAIN_TEXT, P_TRAIN_STEPS)
    finally:
        dist.destroy_process_group()
        pg_file.unlink(missing_ok=True)
    launcher_drive(card)
    log(f"encdec / vlm phase: {time.perf_counter() - t0:.1f} s wall, K3 "
        f"launches {k3} [{card}]")
    return k3


# ---------------------------------------------------------------------------
# phase 13: mesh transparency — ranks of one gloo group sharing the card
# ---------------------------------------------------------------------------

#: the mesh arms' depth cuts (full width): qwen's bf16 serve arm and its
#: fp32 arm, recurrentgemma's serve arm (two super-blocks), the train arms
#: (one step: the fsdp arm moves its 6.2 GB of fp32 embedding and head
#: through the host twice a step over gloo)
MESH_QWEN_LAYERS, MESH_FP32_LAYERS, MESH_RG_LAYERS = 8, 4, 6
MESH_TRAIN_LAYERS, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 2, 1024, 1
#: the two train meshes, after the one-process arm
MESH_TRAIN = (("1x2", "replicated"), ("2x1", "fsdp"))
#: a whole mesh run (both ranks, every arm) must end within this
MESH_TIMEOUT = 420
#: the collectives each arm runs over gloo, on CUDA tensors
MESH_NEEDS = {"qwen": ("all_reduce/float32", "all_gather/bfloat16"),
              "qwen_fp32": ("all_reduce/float32", "all_gather/float32"),
              "recurrentgemma": ("all_gather/int32", "broadcast/int32"),
              "train": ("all_reduce/float32", "all_gather/float32",
                        "all_gather/bfloat16", "broadcast/float32")}


def mesh_probe(torch, dist):
    """Which collectives gloo carries on CUDA tensors here: name ->
    "ok" or the error (NCCL refuses two ranks on one card, so the mesh
    phase's ranks share it over gloo)."""
    dev = torch.device("cuda")
    out = {}
    for op in ("all_reduce", "all_gather", "broadcast"):
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            name = f"{op}/{str(dt).split('.')[-1]}"
            x = torch.full((8,), dist.get_rank() + 1, dtype=dt, device=dev)
            try:
                if op == "all_reduce":
                    dist.all_reduce(x)
                    ok = int(x[0].item()) == 3
                elif op == "all_gather":
                    parts = [torch.empty_like(x) for _ in range(2)]
                    dist.all_gather(parts, x)
                    ok = [int(p[0].item()) for p in parts] == [1, 2]
                else:
                    dist.broadcast(x, src=0)
                    ok = int(x[0].item()) == 1
                out[name] = "ok" if ok else "wrong result"
            except Exception as e:        # reported, and the arm skipped
                out[name] = f"{type(e).__name__}: {str(e)[:120]}"
    return out


def _teacher_forced_on(torch, eng, seq, n_prompt):
    """``teacher_forced_logits`` through a meshed engine's own shards
    (kernels on), under its model axis: every rank calls it."""
    import types
    from repro_torch.models.common import model_axis
    view = types.SimpleNamespace(model=eng.model_cfg, device=eng.device,
                                 params=eng.params, bundle=eng.bundle)
    with model_axis(eng.model_axis):
        return teacher_forced_logits(torch, view, seq, n_prompt, True)


def _mesh_serve_arm(torch, card, rank, arch, mesh, ref, names, **load_kw):
    """Rank ``rank``'s meshed drive of ``arch``: the six requests (the
    qwen drive's), kernels on, every count zeroed before and read after
    (each of ``names`` must launch on this rank); the drive again with
    every launch of ``names`` held against its plain version; the streams
    against the one-process ``ref``, parting only at bf16 near-ties."""
    from repro_torch import api
    sess = api.load(arch, device="cuda", seed=SEED, mesh=mesh, **load_kw)
    cfg = sess.model
    log(f"[{card}] mesh {mesh} rank {rank}: the ranks decode eagerly "
        "(decode_graphs resolves to False with a mesh)")
    prompts = make_prompts(cfg.vocab_size, REPETITIVE[arch],
                           LONG_PROMPT.get(arch, 0))
    sess.serve([prompts[1][:8]], max_new=2)
    torch.cuda.reset_peak_memory_stats()
    outs, wall, counts, m = serve_once(torch, sess, prompts)
    mine = {n: counts[n] for n in names}
    log(f"[{card}] mesh {mesh} rank {rank} {arch} ({cfg.num_layers} "
        f"layers, {cfg.compute_dtype}): {wall:.2f} s, tok/s "
        f"{m['tokens_per_sec']:.2f}, drafted {m['drafted_tokens']} "
        f"accepted {m['accepted_tokens']}, launches {mine}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(v > 0 for v in mine.values()):
        raise AssertionError(f"rank {rank}: kernels not launched: {mine}")
    checked_drive(torch, sess, prompts, outs, names)
    compare_streams(torch, sess, prompts, outs, ref, asserted=True)
    return {"outs": outs, "launches": mine, "wall": wall,
            "tok_s": m["tokens_per_sec"]}


def _train_batch(vocab):
    import numpy as np
    toks = np.random.default_rng(SEED + 5).integers(
        0, vocab, (TRAIN_BATCH, MESH_TRAIN_SEQ + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _mesh_trainer(torch, mesh_shape, dp_mode):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.core.transparent import TransparentTrainer
    from repro_torch.models import registry
    cfg = get_config("qwen2.5-14b").replace(num_layers=MESH_TRAIN_LAYERS)
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("mesh", "train", MESH_TRAIN_SEQ,
                                      TRAIN_BATCH),
                    mesh=MeshConfig(shape=mesh_shape,
                                    axis_names=("data", "model"),
                                    dp_mode=dp_mode),
                    optimizer=OptimizerConfig(name="adam", lr=TRAIN_LR))
    return TransparentTrainer.from_bundle(run, registry.build(cfg),
                                          device="cuda"), cfg


def mesh_train_run(torch, card, mesh_shape, dp_mode, rank=0):
    """MESH_TRAIN_STEPS steps of qwen cut to MESH_TRAIN_LAYERS layers from
    the seeded init on one global batch, each rank on its data-parallel
    slice: [(loss, grad norm)], K3 launches, peak GiB."""
    from repro_torch.kernels.flash_attention import kernel as fk
    torch.cuda.reset_peak_memory_stats()
    tr, cfg = _mesh_trainer(torch, mesh_shape, dp_mode)
    state = tr.init(SEED)
    batch = _train_batch(cfg.vocab_size)
    n = TRAIN_BATCH // tr.dp
    local = {k: v[tr.rank * n:(tr.rank + 1) * n] for k, v in batch.items()}
    fk.flash_attention_kernel.launches = 0
    curve = []
    t0 = time.perf_counter()
    for _ in range(MESH_TRAIN_STEPS):
        state, m = tr.step(state, local)
        curve.append((float(m["loss"]), float(m["grad_norm"])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = fk.flash_attention_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    mesh = "x".join(map(str, mesh_shape))
    log(f"[{card}] train qwen2.5-14b ({MESH_TRAIN_LAYERS} layers, "
        f"{TRAIN_BATCH} x {MESH_TRAIN_SEQ}) mesh {mesh} {dp_mode} rank "
        f"{rank}: losses {[round(l, 5) for l, _ in curve]}, grad norms "
        f"{[round(g, 4) for _, g in curve]}, {wall:.2f} s for "
        f"{MESH_TRAIN_STEPS} steps, K3 {k3} launches, peak {peak:.1f} GiB")
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"curve": curve, "k3": k3, "peak_gib": peak}


def _mesh_rank(rank, world, port, refs, q):
    """One rank of the mesh phase: gloo over TCP on this host, the card
    shared with the other rank; the arms in order, each rank's results
    (or its traceback) on ``q``."""
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        card = refs["card"]
        probe = mesh_probe(torch, dist)
        res = {"probe": probe}
        runs = [a for a, needs in MESH_NEEDS.items()
                if all(probe[n] == "ok" for n in needs)]
        if "qwen" in runs:
            res["qwen"] = _mesh_serve_arm(
                torch, card, rank, "qwen2.5-14b", "1x2", refs["qwen"],
                SERVE_KERNELS["qwen2.5-14b"], num_layers=MESH_QWEN_LAYERS)
            gc.collect()
            torch.cuda.empty_cache()
        if "qwen_fp32" in runs:
            from repro_torch import api
            sess = api.load("qwen2.5-14b", device="cuda", seed=SEED,
                            mesh="1x2", num_layers=MESH_FP32_LAYERS,
                            compute_dtype="float32")
            prompts = make_prompts(sess.model.vocab_size,
                                   REPETITIVE["qwen2.5-14b"])
            outs, _, counts, _ = serve_once(torch, sess, prompts)
            eng = sess.engine
            # numpy, not tensors: a CPU tensor on the queue is shared
            # through a file descriptor that dies with this process
            logits = [_teacher_forced_on(torch, eng, list(p) + list(a),
                                         len(p)).cpu().numpy()
                      for p, a in zip(prompts, refs["qwen_fp32"])]
            res["qwen_fp32"] = {"outs": outs, "logits": logits,
                                "launches": {n: counts[n] for n in
                                             SERVE_KERNELS["qwen2.5-14b"]}}
            del sess, eng
            gc.collect()
            torch.cuda.empty_cache()
        if "recurrentgemma" in runs:
            res["recurrentgemma"] = _mesh_serve_arm(
                torch, card, rank, "recurrentgemma-2b", "2x1",
                refs["recurrentgemma"],
                SERVE_KERNELS["recurrentgemma-2b"],
                num_layers=MESH_RG_LAYERS)
            gc.collect()
            torch.cuda.empty_cache()
        if "train" in runs:
            res["train"] = {
                f"{mesh}/{mode}": mesh_train_run(
                    torch, card, tuple(int(x) for x in mesh.split("x")),
                    mode, rank)
                for mesh, mode in MESH_TRAIN}
        q.put((rank, res))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_spawn(refs, world=2):
    """Start the ranks (spawned processes), collect every rank's results;
    a rank that fails, or none within MESH_TIMEOUT, fails the phase.
    Every process started is joined or killed."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, port, refs, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.time() + MESH_TIMEOUT
        while len(got) < world:
            try:
                rank, res = q.get(timeout=max(deadline - time.time(), 1))
            except queue.Empty:
                raise AssertionError(f"mesh ranks {sorted(set(range(world)) - set(got))} "
                                     f"gave no result within {MESH_TIMEOUT} s")
            if "error" in res:
                raise AssertionError(f"mesh rank {rank} failed:\n"
                                     f"{res['error']}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return [got[r] for r in range(world)]


def _one_process_refs(torch, card):
    """The one-process arms the mesh ranks are held against, run here
    first (the card freed after each): qwen's and recurrentgemma's bf16
    streams, qwen's fp32 streams and teacher-forced logits, the train
    curve."""
    from repro_torch import api
    refs = {"card": card}
    for arch, layers in (("qwen2.5-14b", MESH_QWEN_LAYERS),
                         ("recurrentgemma-2b", MESH_RG_LAYERS)):
        sess = api.load(arch, device="cuda", seed=SEED, num_layers=layers)
        prompts = make_prompts(sess.model.vocab_size, REPETITIVE[arch],
                               LONG_PROMPT.get(arch, 0))
        sess.serve([prompts[1][:8]], max_new=2)
        outs, wall, counts, m = serve_once(torch, sess, prompts)
        log(f"[{card}] one process {arch} ({layers} layers): {wall:.2f} s, "
            f"tok/s {m['tokens_per_sec']:.2f}, launches "
            f"{ {n: counts[n] for n in SERVE_KERNELS[arch]} }")
        refs["qwen" if arch.startswith("qwen") else "recurrentgemma"] = outs
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    sess = api.load("qwen2.5-14b", device="cuda", seed=SEED,
                    num_layers=MESH_FP32_LAYERS, compute_dtype="float32")
    prompts = make_prompts(sess.model.vocab_size, REPETITIVE["qwen2.5-14b"])
    outs, _, _, _ = serve_once(torch, sess, prompts)
    refs["qwen_fp32"] = outs
    refs["qwen_fp32_logits"] = [
        teacher_forced_logits(torch, sess, list(p) + list(a), len(p),
                              True).cpu().numpy()
        for p, a in zip(prompts, outs)]
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    refs["train"] = mesh_train_run(torch, card, (1, 1), "replicated")
    return refs


def mesh_phase(torch, card):
    """Phase 13: the one-process arms, then two ranks of one gloo group
    on the card: qwen2.5-14b (full width, MESH_QWEN_LAYERS layers) served
    tensor-parallel on 1x2, its fp32 arm (MESH_FP32_LAYERS layers),
    recurrentgemma-2b (full width, MESH_RG_LAYERS layers) with its slots
    over data on 2x1, and qwen trained on 1x2 and on 2x1 with fsdp; every
    rank's counts, checked launches, streams and step-1 numbers against
    the one-process arms."""
    t0 = time.perf_counter()
    refs = _one_process_refs(torch, card)
    mesh_ref = {k: v for k, v in refs.items() if k != "qwen_fp32_logits"}
    gc.collect()
    torch.cuda.empty_cache()
    ranks = mesh_spawn(mesh_ref)
    probe = ranks[0]["probe"]
    log(f"[{card}] gloo collectives on CUDA tensors: {probe}")
    for arm, needs in MESH_NEEDS.items():
        missing = [n for n in needs if probe[n] != "ok"]
        if missing:
            log(f"mesh arm {arm} not run: gloo cannot carry {missing} here")
    for rank, res in enumerate(ranks):
        if "qwen_fp32" in res:
            r = res["qwen_fp32"]
            if not all(v > 0 for v in r["launches"].values()):
                raise AssertionError(f"fp32 mesh rank {rank}: {r['launches']}")
            worst = max(float(abs(a - b).max()) for a, b in
                        zip(r["logits"], refs["qwen_fp32_logits"]))
            same = sum(a == b for a, b in zip(r["outs"], refs["qwen_fp32"]))
            log(f"[{card}] fp32 mesh 1x2 rank {rank}: teacher-forced logits "
                f"within {worst:.3g} of one process (tol "
                f"{FP32_LOGIT_ATOL:.3g}); {same}/{len(r['outs'])} streams "
                f"identical; launches {r['launches']}")
            if worst > FP32_LOGIT_ATOL or same != len(r["outs"]):
                raise AssertionError(f"fp32 mesh arm: {worst}, {same}")
        for name, run in res.get("train", {}).items():
            (l1, g1), (l0, g0) = run["curve"][0], refs["train"]["curve"][0]
            dl, dg = abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0)
            log(f"[{card}] train {name} rank {rank}: step-1 loss {l1:.6f} vs "
                f"one process {l0:.6f} (rel {dl:.2e}, tol {LOSS_RTOL:g}), "
                f"grad norm {g1:.5f} vs {g0:.5f} (rel {dg:.2e}, tol "
                f"{GNORM_RTOL:g}); K3 {run['k3']}; peak {run['peak_gib']:.1f} "
                f"GiB (one process {refs['train']['peak_gib']:.1f})")
            if dl > LOSS_RTOL or dg > GNORM_RTOL or run["k3"] <= 0:
                raise AssertionError(f"mesh train {name} rank {rank}: "
                                     f"{dl}, {dg}, K3 {run['k3']}")
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: analysis — the sampler on the card, the dry run against the card
# ---------------------------------------------------------------------------

#: (a) the sampler's rows, over qwen2.5-14b's vocabulary
SAMPLER_ROWS, QWEN_VOCAB = 64, 152064
#: (a) a parting between the card's and the CPU's sampled token must sit
#: at a near-tie of the CPU's perturbed scores (filtered logits / T +
#: Gumbel noise, |score| < ~30): the two devices' softmax, cumsum and log
#: round differently in the last fp32 bits
SAMPLER_TIE = 1e-4
#: (b) the profiled full-width qwen cells: (shape preset, batch, sequence)
#: — a prefill of 2 x 4,096 tokens (K3 in every layer) and a decode step
#: of 32 slots at a 4,096-token context (26 GB of cache beside 29.5 GB of
#: bf16 weights)
ANALYSIS_CELLS = (("prefill_32k", 2, 4096), ("decode_32k", 32, 4096))
#: (c) the sampled qwen drive's per-request parameters
SAMPLED_DRIVE = [dict(temperature=0.8, top_k=40, top_p=0.95, seed=i)
                 for i in range(6)]


def _sampler_rows(torch, n):
    """Packed rows over a grid of temperature, top-k and top-p."""
    from repro_torch.serving.sampling import SamplingParams, pack_params
    import numpy as np
    grid = [(t, k, p) for t in (0.0, 0.7, 1.3) for k in (0, 50)
            for p in (1.0, 0.9)]
    rows = [pack_params(SamplingParams(
        temperature=grid[i % len(grid)][0], top_k=grid[i % len(grid)][1],
        top_p=grid[i % len(grid)][2], seed=(7919 * i) % (2 ** 31)))
        for i in range(n)]
    return torch.from_numpy(np.stack(rows))


def _perturbed(torch, logits, packed, idx):
    """The sampler's scores on the CPU before its filters: the logits over
    the temperature plus the row's Gumbel noise (greedy rows: the logits)
    — two tokens both devices kept compare on these."""
    from repro_torch.serving import sampling
    temp = packed[:, 0].contiguous().view(torch.float32)
    g = sampling.gumbel(sampling.fold_in(packed[:, 3], idx), logits.shape[1])
    scores = logits / torch.clamp(temp, min=1e-6)[:, None] + g
    return torch.where((temp > 0)[:, None], scores, logits)


def sampler_check(torch, card):
    """(a) threefry on the card against the CPU over 64 rows of qwen's
    vocabulary on identical fp32 logits: the raw bits must be equal, every
    sampled token too but at a near-tie of the perturbed scores."""
    from repro_torch.serving import sampling
    gen = torch.Generator().manual_seed(SEED)
    logits = torch.randn(SAMPLER_ROWS, QWEN_VOCAB, generator=gen) * 4.0
    packed = _sampler_rows(torch, SAMPLER_ROWS)
    idx = torch.randint(0, 1 << 20, (SAMPLER_ROWS,), generator=gen,
                        dtype=torch.int32)
    key = sampling.fold_in(packed[:, 3], idx)
    cpu_bits = sampling.random_bits(key, QWEN_VOCAB)
    dev_key = sampling.fold_in(packed[:, 3].cuda(), idx.cuda())
    dev_bits = sampling.random_bits(dev_key, QWEN_VOCAB).cpu()
    same_bits = int((cpu_bits == dev_bits).sum())
    cpu_tok = sampling.sample_tokens(logits, packed, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_tok = sampling.sample_tokens(logits.cuda(), packed.cuda(), idx.cuda())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    dev_tok = dev_tok.cpu()
    parted = [r for r in range(SAMPLER_ROWS) if cpu_tok[r] != dev_tok[r]]
    log(f"analysis (a): threefry bits card vs CPU: {same_bits} / "
        f"{cpu_bits.numel()} equal; sampled tokens {SAMPLER_ROWS - len(parted)}"
        f" / {SAMPLER_ROWS} equal (the card's first sampler call, host "
        f"clock: {ms:.2f} ms for {SAMPLER_ROWS} x {QWEN_VOCAB}) [{card}]")
    if same_bits != cpu_bits.numel():
        raise AssertionError("threefry bits differ between the card and the "
                             "CPU")
    if parted:
        scores = _perturbed(torch, logits[parted], packed[parted],
                            idx[parted])
        for j, r in enumerate(parted):
            a, b = int(cpu_tok[r]), int(dev_tok[r])
            gap = abs(float(scores[j, a] - scores[j, b]))
            log(f"  row {r}: CPU {a} vs card {b}; perturbed-score gap "
                f"{gap:.3g} (tie tolerance {SAMPLER_TIE:g})")
            if gap > SAMPLER_TIE:
                raise AssertionError(f"sampler row {r} parts at gap {gap}")


def profile_cell_drive(card, shape, batch, seq):
    """``python -m repro_torch.roofline.profile_cell --device cuda`` on one
    full-width qwen cell, in a process of its own; returns its JSON."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.roofline.profile_cell",
           "--arch", "qwen2.5-14b", "--shape", shape, "--device", "cuda",
           "--batch", str(batch), "--seq-len", str(seq), "--top", "10"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=900)
    for line in r.stdout.strip().splitlines()[:-1]:
        log(f"  | {line}")
    if r.returncode != 0:
        log(r.stderr[-4000:])
        raise AssertionError(f"profile_cell {shape} failed: rc "
                             f"{r.returncode}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    p, m = rec["predicted"], rec["measured"]
    log(f"analysis (b): qwen2.5-14b {shape} cut to {batch} x {seq} on one "
        f"card: predicted {p['step_s'] * 1e3:.2f} ms (compute "
        f"{p['compute_s'] * 1e3:.2f}, memory {p['memory_s'] * 1e3:.2f}) vs "
        f"measured {m['wall_s'] * 1e3:.2f} ms a step, device busy "
        f"{100 * m['busy_share']:.1f}%, {m['kernel_launches']} launches; "
        f"peak {m['peak_bytes'] / 1e9:.2f} GB measured vs "
        f"{p['peak_bytes'] / 1e9:.2f} GB dry run; hand-written kernels "
        f"{ {k: v for k, v in m['launches'].items() if v} or 'none'} "
        f"(process {time.perf_counter() - t0:.1f} s, dry run "
        f"{rec['dry_run_s']:.1f} s) [{card}]")
    q = rec["measured_plain"]
    if q is not None:
        log(f"analysis (b): the same cell with use_kernels=False (the path "
            f"the dry run counts): {q['wall_s'] * 1e3:.2f} ms a step, device "
            f"busy {100 * q['busy_share']:.1f}%, {q['kernel_launches']} "
            f"launches, peak {q['peak_bytes'] / 1e9:.2f} GB [{card}]")
        if any(q["launches"].values()):
            raise AssertionError(f"the plain arm launched {q['launches']}")
    return rec


@contextlib.contextmanager
def recorded_draws(torch):
    """Every sampled draw the serving engine makes inside: each
    ``sample_tokens`` call's fp32 logits, packed rows, indices and tokens,
    copied to the host (a sync per call)."""
    from repro_torch.serving import engine
    real, calls = engine.sample_tokens, []

    def record(logits, packed, idx, **kw):
        out = real(logits, packed, idx, **kw)
        calls.append(tuple(t.detach().cpu() for t in (
            logits.float(), packed, idx, out)))
        return out
    engine.sample_tokens = record
    try:
        yield calls
    finally:
        engine.sample_tokens = real


def served_logits(torch, calls, row, idx, tok, what):
    """The logits a serving arm drew ``tok`` from: the recorded draw of the
    packed sampling ``row`` at sequence index ``idx`` (a frozen slot's
    replays draw it again, alike).  Fails where no draw was recorded
    there, or none gave ``tok``."""
    from repro_torch.serving.sampling import PACKED_WIDTH
    found = []
    for lg, pk, ix, out in calls:
        hit = ((ix.long() == idx)
               & (pk[:, :PACKED_WIDTH] == row).all(dim=-1)).nonzero()
        found += [(lg[r], int(out[r])) for r in hit[:, 0].tolist()]
    if not found:
        raise AssertionError(f"{what}: no draw recorded at index {idx}")
    for lg, t in found:
        if t == tok:
            return lg
    raise AssertionError(f"{what}: the draws recorded at index {idx} gave "
                         f"{sorted({t for _, t in found})}, not {tok}")


def parting_margin(torch, logits, sp, idx, a, b):
    """How close one arm's logits sit to flipping its draw between tokens
    ``a`` and ``b``, in logit units, and by which edge: the two tokens'
    perturbed scores (scaled logits plus the row's Gumbel noise) where
    both pass the filters; either token's scaled logit against the k-th
    largest (top-k); either token's mass ranked above it against top_p,
    as the logit shift that moves that mass there (a shift of every logit
    by at most d moves it by a factor within exp(+-2d/T))."""
    from repro_torch.serving import sampling
    T = sp.temperature
    z = logits.float() / T
    desc = torch.sort(z, descending=True).values
    kth = float(desc[sp.top_k - 1]) if sp.top_k else float("-inf")
    kept = torch.where(z >= kth, z, torch.full((), -float("inf")))
    p = torch.softmax(kept, dim=-1)
    g = sampling.gumbel(sampling.fold_in(
        torch.tensor([sp.seed], dtype=torch.int32),
        torch.tensor([idx], dtype=torch.int32)), z.numel())[0]
    edges = []
    if z[a] >= kth and z[b] >= kth:
        edges.append((T * abs(float(z[a] + g[a] - z[b] - g[b])), "near-tie"))
    if sp.top_k:
        edges += [(T * abs(float(z[t]) - kth), f"top-k edge ({t})")
                  for t in (a, b)]
    if sp.top_p < 1.0:
        for t in (a, b):
            m = float(p[p > p[t]].sum())
            edges.append((T * abs(m - sp.top_p) / (2 * max(m, 1e-9)),
                          f"top-p edge ({t})"))
    return min(edges)


def sampled_arm(torch, sess, prompts, card):
    """(c) the qwen drive with sampling (per-request temperature, top-k,
    top-p and seed), kernels on: the kernels must launch and the streams
    be well formed; then the checked drive, every K1 / K2 launch of the
    sampled drive held against its plain version on its own inputs; then
    kernels off.  Both arms record the logits of every draw the engine
    makes (``recorded_draws``).  Where a kernel stream parts from the
    plain one, each arm's own logits at that index, in its own batch,
    must give its own token (the witness is the serving step itself), and
    the parting must sit within bf16 rounding: on one arm's logits, the
    smallest ``parting_margin`` at most TIE_ULPS bf16 ulps of the top
    logit — the greedy drives' near-tie rule, with the sampler's filters
    as further edges.  The arms' logits there differ by some d; one arm's
    margin is at most d, so the rule fails where d passes that rounding
    and the flip does not sit at a nearer edge."""
    from repro_torch.serving import sampling
    samp = [sampling.SamplingParams(**kw) for kw in SAMPLED_DRIVE]
    names = SERVE_KERNELS["qwen2.5-14b"]
    # recording wraps the engine's sampler (a Python function): the
    # recorded arms decode eagerly; the graphed sampled drive after the
    # kernel arm must give its streams token for token
    log("analysis (c): the recorded arms decode eagerly (decode_graphs="
        "False; recorded_draws wraps a Python function)")
    with recorded_draws(torch) as kcalls:
        outs, wall, counts, m = serve_once(torch, sess, prompts,
                                           sampling=samp,
                                           decode_graphs=False)
    log(f"analysis (c): sampled qwen drive (kernels; draws recorded): "
        f"{wall:.2f} s, tok/s {m['tokens_per_sec']:.2f}; drafted "
        f"{m['drafted_tokens']} accepted {m['accepted_tokens']}; launches "
        f"{ {n: counts[n] for n in names} } [{card}]")
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched in the sampled drive")
    for o in outs:
        if len(o) != MAX_NEW or not all(0 <= t < sess.model.vocab_size
                                        for t in o):
            raise AssertionError(f"bad sampled stream {o}")
    graphed, gwall, gcounts, _ = serve_once(torch, sess, prompts,
                                            sampling=samp)
    log(f"analysis (c): sampled qwen drive (kernels, decode graphs): "
        f"{gwall:.2f} s; launches { {n: gcounts[n] for n in names} }; "
        f"{sum(a == b for a, b in zip(graphed, outs))}/{len(outs)} streams "
        f"equal to the eager kernel arm's token for token [{card}]")
    if not DRIVE["decode_graphs"] or graphed != outs:
        raise AssertionError("the graphed sampled drive differs from the "
                             "eager one")
    checked_drive(torch, sess, prompts, outs, names, sampling=samp)
    with recorded_draws(torch) as pcalls:
        plain, pwall, pcounts, _ = serve_once(torch, sess, prompts,
                                              sampling=samp,
                                              use_kernels=False,
                                              decode_graphs=False)
    if any(pcounts.values()):
        raise AssertionError(f"plain sampled arm launched kernels: {pcounts}")
    same = 0
    for i, (a, b) in enumerate(zip(outs, plain)):
        if a == b:
            same += 1
            continue
        j = next(k for k in range(len(a)) if a[k] != b[k])
        row = torch.from_numpy(sampling.pack_params(samp[i]))
        idx = len(prompts[i]) + j
        lk = served_logits(torch, kcalls, row, idx, a[j], f"request {i} "
                           "kernel arm")
        lp = served_logits(torch, pcalls, row, idx, b[j], f"request {i} "
                           "plain arm")
        tie = bf16_tie(float(lp.max()))
        margin, edge = min(parting_margin(torch, lg, samp[i], idx, a[j], b[j])
                           for lg in (lk, lp))
        log(f"  request {i}: sampled streams part at index {j} ({a[j]} vs "
            f"{b[j]}), each arm's recorded logits giving its own token; the "
            f"arms' logits there differ by up to "
            f"{float((lk - lp).abs().max()):.4g}; nearest edge: {edge} at "
            f"{margin:.4g} (bf16 tie {tie:.4g})")
        if margin > tie:
            raise AssertionError(f"sampled request {i} parts at {j} beyond "
                                 "bf16 rounding of its draw")
    log(f"analysis (c): plain sampled arm (draws recorded) {pwall:.2f} s; "
        f"{same}/{len(outs)} sampled streams identical to the kernel arm's, "
        "the rest part within bf16 rounding of a near-tie or a filter edge")


def analysis_phase(torch, card):
    """(a) the sampler on the card against the CPU; (b) the dry run of the
    full-width qwen cells on one device against the same cells profiled
    on the card (``profile_cell --device cuda``); the prefill must launch
    K3.  Returns the cells' records."""
    sampler_check(torch, card)
    recs = {}
    for shape, batch, seq in ANALYSIS_CELLS:
        rec = profile_cell_drive(card, shape, batch, seq)
        recs[shape] = rec
    k3 = recs["prefill_32k"]["measured"]["launches"]["K3"]
    if k3 <= 0:
        raise AssertionError("the full-width prefill cell never launched K3")
    return recs


#: phase name -> wall seconds (``phase``)
PHASE_S = {}


@contextlib.contextmanager
def phase(name):
    """Print the wall seconds of one phase of the full run."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        log(f"phase {name}: {PHASE_S[name]:.1f} s wall")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # --kernels K2,K6 [SRC] (--decode-kernels [SRC]: K1,K4): the named
    # kernels of the package under SRC (default this checkout's src/)
    # alone, built and timed
    args = sys.argv[1:]
    names = only = None
    if args[:1] == ["--decode-kernels"]:
        names, args = ["K1", "K4"], args[1:]
    elif args[:1] == ["--kernels"] and len(args) > 1:
        names, args = args[1].split(","), args[2:]
        unknown = set(names) - set(KERNEL_ROWS)
        if unknown:
            print(f"chip_smoke: unknown kernels {sorted(unknown)}; "
                  f"choose from {sorted(KERNEL_ROWS)}", file=sys.stderr)
            return 2
    elif args in (["--train"], ["--encdec"], ["--mesh"], ["--analysis"]):
        names, only = [], args[0]
    elif args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
    src = Path(args[0]) if names and args else ROOT / "src"
    sys.path.insert(0, str(src.resolve()))
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if names:
        from repro_torch.kernels import build
        env_phase(torch)
        log(f"kernels {','.join(names)} of {build.CSRC}")
        logs = build.build_all(sorted({KERNEL_ROWS[n][0] for n in names}))
        for text in logs.values():
            for fn, info in _ptxas_report(text):
                PTXAS[fn] = info
                log(f"  ptxas: {info}  {fn[:110]}")
        return 0 if kernels_only_phase(torch, F, names) else 1

    card = env_phase(torch)
    if names == []:                     # --train / --encdec: one phase alone
        build_phase()
        if only == "--train":
            train_phase(torch, card)
        elif only == "--mesh":
            mesh_phase(torch, card)
        elif only == "--analysis":
            analysis_phase(torch, card)
            sess, prompts = load_for_serving(torch, "qwen2.5-14b")
            sampled_arm(torch, sess, prompts, card)
        else:
            count_model_calls()
            encdec_vlm_phase(torch, card)
        return 0
    count_model_calls()
    t_start = time.perf_counter()
    with phase("build"):
        build_phase()
    with phase("kernels"):
        stats = kernel_phase(torch, F)
    # profile marks: K1 / K4's kernel, and K2's (K5's on mixtral): the bf16
    # body paged_prefill_wgmma_kernel with its split merge
    # prefill_merge_kernel, or the scalar paged_*prefill_kernel
    with phase("serve qwen2.5-14b"):
        counts = serve_phase(torch, "qwen2.5-14b",
                             ("paged_decode_kernel", "prefill"), card)
        gc.collect()                    # the serve session and its engines
        torch.cuda.empty_cache()
    qwen_k3 = counts.pop("flash_attention")           # the slotted arm's
    with phase("train"):
        counts["flash_attention"] = train_phase(torch, card)["launches"]
        gc.collect()                    # the train sessions
        torch.cuda.empty_cache()
    with phase("serve deepseek-v2-lite-16b"):
        counts.update(serve_phase(
            torch, "deepseek-v2-lite-16b",
            ("paged_mla_decode_kernel", "paged_mla_prefill_kernel")))
        moe_k11 = counts.pop("moe_grouped")
        gc.collect()                    # the bf16 deepseek session
        torch.cuda.empty_cache()
    with phase("fp32 deepseek-v2-lite-16b"):
        fp32_phase(torch)
    with phase("serve recurrentgemma-2b"):
        rg = serve_phase(torch, "recurrentgemma-2b",
                         ("lru_scan_kernel", "flash_fwd_kernel"))
        gc.collect()
        torch.cuda.empty_cache()
    with phase("serve rwkv6-1.6b"):
        counts.update(serve_phase(torch, "rwkv6-1.6b", ("wkv6_kernel",)))
        gc.collect()
        torch.cuda.empty_cache()
    counts["lru_scan"] = rg["lru_scan"]
    # K3 runs on three paths: the train drives (qwen's and recurrentgemma's),
    # qwen's slotted prefill and recurrentgemma's local-attention prefill
    log(f"K3 launches: train {counts['flash_attention']}, qwen slotted "
        f"{qwen_k3}, recurrentgemma {rg['flash_attention']}")
    counts["flash_attention"] += qwen_k3 + rg["flash_attention"]
    for arch in ("recurrentgemma-2b", "rwkv6-1.6b"):
        with phase(f"fp32 {arch}"):
            fp32_phase(torch, arch)
    with phase("serve mixtral-8x22b"):
        counts.update(serve_phase(torch, "mixtral-8x22b",
                                  ("paged_decode_kernel", "prefill")))
        log(f"K11 launches: deepseek {moe_k11}, mixtral "
            f"{counts['moe_grouped']}")
        counts["moe_grouped"] += moe_k11
        gc.collect()                    # the bf16 mixtral session
        torch.cuda.empty_cache()
    with phase("fp32 mixtral-8x22b"):
        fp32_phase(torch, "mixtral-8x22b")
    with phase("encdec / vlm"):
        modal_k3 = encdec_vlm_phase(torch, card)
        log(f"K3 launches: whisper / pixtral {modal_k3}")
        counts["flash_attention"] += modal_k3
        gc.collect()
        torch.cuda.empty_cache()
    with phase("mesh"):
        mesh_phase(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
    with phase("analysis"):
        analysis_phase(torch, card)
    log(f"phases (s): { {k: round(v, 1) for k, v in PHASE_S.items()} }; "
        f"total {time.perf_counter() - t_start:.1f} s after the environment "
        f"[{card}]")

    sources = {"paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/kernel.py:199"),
               "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                                 "src/repro/kernels/paged_attention/kernel.py:436"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:109"),
               "paged_mla": ("src/repro_torch/csrc/paged_mla.cu",
                             "src/repro/kernels/paged_attention/kernel.py:290"),
               "paged_mla_prefill": ("src/repro_torch/csrc/paged_mla_prefill.cu",
                                     "src/repro/kernels/paged_attention/kernel.py:696"),
               "lru_scan": ("src/repro_torch/csrc/lru_scan.cu",
                            "src/repro/kernels/rglru_scan/kernel.py:59"),
               "wkv6": ("src/repro_torch/csrc/wkv6.cu",
                        "src/repro/kernels/rwkv6_wkv/kernel.py:66"),
               "paged_ring_decode": (
                   "src/repro_torch/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention/kernel.py:199"),
               "paged_ring_prefill": (
                   "src/repro_torch/csrc/paged_ring_prefill.cu",
                   "src/repro/kernels/paged_attention/kernel.py:598"),
               "paged_attention_int8": (
                   "src/repro_torch/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention/kernel.py:113"),
               "paged_prefill_int8": (
                   "src/repro_torch/csrc/paged_prefill.cu",
                   "src/repro/kernels/paged_attention/kernel.py:365"),
               "paged_ring_decode_int8": (
                   "src/repro_torch/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention/kernel.py:113"),
               "paged_ring_prefill_int8": (
                   "src/repro_torch/csrc/paged_ring_prefill.cu",
                   "src/repro/kernels/paged_attention/kernel.py:490"),
               "moe_grouped": (
                   "src/repro_torch/csrc/moe_grouped.cu",
                   "none: the JAX package's dense einsum dispatch "
                   "(src/repro/models/moe.py moe_apply(per_token=True))")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = stats[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **{k: v for k, v in r.items()
                           if k.startswith(("verify_", "bucket_"))
                           or k in ("device_ms", "library_device_ms")}})
    # a time the profiler did not record is null, not NaN (not JSON)
    log(json.dumps({"kernels": [
        {k: None if isinstance(v, float) and math.isnan(v) else v
         for k, v in row.items()} for row in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
