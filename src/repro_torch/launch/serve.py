"""Serving CLI: a thin adapter over ``repro_torch.api`` — flags in, a
``Session.serve`` call out.  The Session owns the continuous-batching
engine (``repro_torch.serving``): admission queue, per-slot KV insertion /
eviction, fixed-shape batched decode, paged-vs-slotted KV layout chosen by
the bundle's declared capabilities.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2.5-14b --smoke --requests 8 --prompt-len 16 --max-new 12 \
        --device cpu

On an H100 drop ``--device cpu`` and ``--smoke``: the hand-written CUDA
kernels run, on full configs only (the smoke configs' head_dim 16 is not
one the kernels take, and their wrappers raise), so ``--smoke`` needs
``--device cpu``.  ``--mesh DxM`` serves over ``D·M`` processes
(tensor-parallel decode over the model axis, data-parallel slots on the
slotted pool), started with ``torch.distributed.run --nproc-per-node
D·M``; every rank serves the same requests and rank 0 prints.  Prompt
lengths are jittered to exercise ragged continuous batching.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import cli


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    cli.add_session_flags(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (fixed batched-decode shape)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length (lengths jittered down to half)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--policy", choices=("fcfs", "priority"), default="fcfs")
    ap.add_argument("--max-prefills-per-step", "--prefill-chunk", type=int,
                    default=2, dest="max_prefills_per_step",
                    help="request admissions per engine cycle "
                         "(--prefill-chunk is the deprecated spelling)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="split prefills longer than this into per-cycle "
                         "chunks interleaved with decode (0 = whole prompt)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix-cache page sharing (paged layout)")
    ap.add_argument("--no-prefill-bucket", action="store_true",
                    help="disable power-of-two prefill length bucketing "
                         "(compiles one prefill per distinct prompt length)")
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--kv-layout", choices=("auto", "paged", "slotted"),
                    default="auto",
                    help="KV-cache layout: page-granular (any family with "
                         "a KVLayout: full/swa/local k-v pages, MLA latent "
                         "pages) vs slot-granular preallocation")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8"), default="fp32",
                    help="paged KV page storage dtype: fp32 keeps the "
                         "model's compute dtype; int8 stores k/v pages "
                         "quantized with per-page-per-head bf16 scales "
                         "(dequant fused into the paged-attention kernels; "
                         "MLA latent pages stay fp)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (paged layout; default 16, "
                         "auto-shrunk for short runs and to tile the "
                         "attention window of swa/local families)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="shared page pool size; 0 = worst case, less "
                         "oversubscribes (engine preempts on pressure)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every request "
                         "(0 = greedy argmax, the default); sampled rows "
                         "draw the reference's threefry bits")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep the k highest logits before sampling "
                         "(0 disables the filter)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling: keep the smallest prob mass "
                         ">= top_p (1.0 disables the filter)")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="max draft tokens per speculative verify "
                         "(paged layouts; see --no-spec)")
    ap.add_argument("--no-spec", action="store_true",
                    help="disable speculative decoding (n-gram drafting + "
                         "one-forward verification; output tokens are "
                         "identical either way — spec only changes speed)")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous escape hatch: pipeline_depth=1 — "
                         "retire every cycle before planning the next "
                         "(default pipeline_depth=2 overlaps host planning "
                         "with the in-flight device step)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are emitted")
    ap.add_argument("--json", action="store_true",
                    help="emit the metrics summary as JSON")
    ap.add_argument("--trace", metavar="PATH", default="",
                    help="run the engine traced (repro_torch.obs) and write a "
                         "Perfetto-loadable Chrome trace JSON here; also "
                         "prints the per-phase times (host step and plan "
                         "seconds; the card's prefill, decode and verify "
                         "seconds from stream events)")
    args = ap.parse_args()

    # require the serve capability at load time: a family the engine cannot
    # serve fails in one line here, not mid-run
    session = cli.make_session(args, require=("serve",))

    import numpy as np
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1,
                           size=args.requests)
    vocab = session.model.vocab_size
    prompts = [list(rng.integers(0, vocab, (int(l),))) for l in lengths]

    stream = None
    if args.stream:
        def stream(rid, tok, done):
            print(f"  req {rid} -> {tok}{'  [done]' if done else ''}",
                  flush=True)

    # --seed doubles as the sampling seed: with --temperature > 0 every
    # request draws from the same per-request (seed, token index) keyed
    # PRNG, so a rerun with identical flags reproduces its tokens exactly
    sampling = None
    if args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0:
        from repro_torch.serving import SamplingParams
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.seed)

    seq_cap = args.prompt_len + args.max_new
    # without --page-size the Session auto-sizes pages from the model's
    # KVLayout (shrinks for short runs, tiles swa/local windows); an
    # explicit --page-size that doesn't fit should fail validation
    page_kw = {} if args.page_size is None else \
        {"page_size": args.page_size}
    outs = session.serve(
        prompts, max_new=args.max_new, stream=stream,
        max_batch=args.batch, max_queue=args.max_queue,
        max_seq_len=seq_cap, policy=args.policy,
        max_prefills_per_step=args.max_prefills_per_step,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        enable_prefix_cache=not args.no_prefix_cache,
        prefill_bucket=not args.no_prefill_bucket,
        decode_steps=args.decode_steps,
        kv_layout=args.kv_layout, kv_dtype=args.kv_dtype,
        pipeline_depth=1 if args.sync else 2,
        num_pages=args.num_pages, trace=bool(args.trace),
        spec_tokens=args.spec_tokens, enable_spec=not args.no_spec,
        sampling=sampling, **page_kw)
    import torch.distributed as dist
    if dist.is_initialized():
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:
            return                    # every rank served the same streams
    engine = session.engine
    s = engine.metrics.summary()
    if args.json:
        print(json.dumps(s, indent=2))
    else:
        print(f"served {s['completed']}/{args.requests} requests, "
              f"{s['tokens_out']} tokens in {s['elapsed_s']:.2f}s "
              f"({s['tokens_per_sec']:.1f} tok/s)")
        print(f"  ttft   p50 {s['ttft_p50_s']*1e3:8.1f} ms   "
              f"p99 {s['ttft_p99_s']*1e3:8.1f} ms")
        print(f"  itl    p50 {s['itl_p50_s']*1e3:8.1f} ms   "
              f"p99 {s['itl_p99_s']*1e3:8.1f} ms")
        print(f"  queue  max {s['queue_depth_max']}  "
              f"preemptions {s['preemptions']}  rejected {s['rejected']}")
        layout = "paged" if engine.paged else "slotted"
        print(f"  kv     {layout}/{args.kv_dtype}  "
              f"peak {s['kv_bytes_peak']/1e6:.2f} MB  "
              f"(slotted pool would pin {s['kv_bytes_slotted']/1e6:.2f} MB)")
        if engine.paged and engine.layout.quantized:
            pool = engine.pool
            print(f"  kvq    {pool.page_bytes} B/page quantized vs "
                  f"{pool.page_bytes_fp32} B/page fp32 "
                  f"({pool.page_bytes / pool.page_bytes_fp32:.2f}x — "
                  f"{pool.page_bytes_fp32 / pool.page_bytes:.1f}x more "
                  f"tokens in the same HBM)")
        print(f"  prefill  {s['prefill_tokens']} tokens run, "
              f"{s['prefill_tokens_saved']} served from prefix cache "
              f"(hit rate {s['prefix_hit_rate']:.2f}), "
              f"{s['compile_count']} compiles")
        if s["drafted_tokens"]:
            print(f"  spec     {s['drafted_tokens']} drafted, "
                  f"{s['accepted_tokens']} accepted "
                  f"(accept_rate {s['accept_rate']:.2f})")
        if s["step_time_s"] > 0:
            clock = "card" if engine.device.type == "cuda" else "host"
            device = (f"{clock} prefill {s['prefill_time_s']:.3f}s  "
                      f"decode {s['decode_time_s']:.3f}s  "
                      f"verify {s['verify_time_s']:.3f}s "
                      f"(decode {s['decode_tokens_per_sec']:.1f} tok/s, "
                      f"prefill {s['prefill_tokens_per_sec']:.1f} tok/s)")
            print(f"  phases host step {s['step_time_s']:.2f}s, plan "
                  f"{s['plan_time_s']:.3f}s, draft "
                  f"{s['draft_time_s']:.3f}s; {device}")
        for i, toks in enumerate(outs):
            print(f"  req {i}: {toks[:8]}{'...' if len(toks) > 8 else ''}")
    if args.trace:
        print(f"trace written to {session.save_trace(args.trace)} "
              "(load in ui.perfetto.dev)", flush=True)


if __name__ == "__main__":
    main()
