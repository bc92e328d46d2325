"""Profile one cell: the dry run's three roofline terms and top FLOP, byte
and collective contributors — and, with ``--device cuda``, the same cell
run for real on one card beside them.

The port of ``src/repro/roofline/profile_cell.py``:

  PYTHONPATH=src python -m repro_torch.roofline.profile_cell \\
      --arch qwen2.5-14b --shape train_4k --mesh single --mode fsdp

prints the prediction for one rank of the production mesh (the fake run of
``launch/dryrun.py``).  With ``--device cuda`` the cell is cut to one
card: the arch at its full width and depth, the shape's batch and
sequence length cut by ``--batch`` / ``--seq-len``, no mesh; the config
overrides (``--remat``, ``--q-block``, ``--kv-block``, ``--attn-remat``)
apply to both runs, and the mesh and train ones (``--microbatch``,
``--allreduce-override``, ``--rules``) are refused.  The dry run of that
single-device cell is the prediction; then the cell runs on the card with
the kernels (random bf16 weights from a seed; a decode cell's cache holds
``--seq-len - 1`` positions, so the step attends over a full context):
one warm-up step, STEPS timed steps (host clock, synchronised), one step
under ``torch.profiler``.  Printed
beside the predicted terms: wall per step, device time by kernel name
with K1-K10 named as ``chip_smoke.py`` names them, the busy share of the
wall, kernel launches (all, and each hand-written kernel's own count),
and ``torch.cuda.max_memory_allocated`` against the dry run's peak; a
prefill cell also runs with ``use_kernels=False``, the plain path the dry
run counts.  The last line is one JSON object with all of it.

A card run that finds no CUDA fails; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.roofline import hw

#: kernel-name markers of the hand-written kernels (first match wins),
#: and their names in ``chip_smoke.py``'s kernel table
KERNEL_MARKS = (("paged_mla_decode_kernel", "K6"),
                ("paged_mla_prefill_kernel", "K7"),
                ("paged_decode_kernel", "K1/K4"),
                ("paged_ring_prefill_kernel", "K5"),
                ("paged_prefill_wgmma_kernel", "K2/K5"),
                ("prefill_merge_kernel", "K2/K5 merge"),
                ("paged_prefill_kernel", "K2"),
                ("flash_fwd_kernel", "K3"),
                ("lru_scan_kernel", "K9"),
                ("wkv6_kernel", "K10"))
#: the kernel wrappers whose ``launches`` count a run's launches
WRAPPERS = {"K1/K4/K8": ("paged_attention", "paged_attention_kernel"),
            "K2/K8": ("paged_attention", "paged_prefill_kernel"),
            "K5/K8": ("paged_attention", "paged_ring_prefill_kernel"),
            "K6": ("paged_attention", "paged_mla_kernel"),
            "K7": ("paged_attention", "paged_mla_prefill_kernel"),
            "K3": ("flash_attention", "flash_attention_kernel"),
            "K9": ("rglru_scan", "lru_scan_kernel"),
            "K10": ("rwkv6_wkv", "wkv6_kernel")}
GEMM_MARKS = ("nvjet", "gemm", "cutlass", "xmma")
#: the kernels arm's timed steps on the card (the plain arm times one)
STEPS = 3


def kernel_label(name: str) -> str:
    for mark, label in KERNEL_MARKS:
        if mark in name:
            return label
    return ""


def _wrappers():
    import importlib
    return {k: getattr(importlib.import_module(
        f"repro_torch.kernels.{pkg}.kernel"), fn)
        for k, (pkg, fn) in WRAPPERS.items()}


def terms(stats) -> dict:
    """The three roofline terms of a counter's stats (see
    ``roofline/analysis.py``)."""
    from repro_torch.roofline.analysis import compute_seconds
    return {"compute_s": compute_seconds(stats.flops, stats.fp32_flops),
            "memory_s": stats.hbm_bytes / hw.HBM_BW,
            "collective_s": sum(
                w / (hw.NVLINK_BW if p <= hw.GPUS_PER_NODE else hw.IB_BW)
                for p, w in stats.wire_bytes_by_group().items())}


def print_dry_run(title, stats, peak, top):
    t = terms(stats)
    print(f"=== {title}")
    print(f"compute {t['compute_s']:10.4f}s   memory {t['memory_s']:10.4f}s"
          f"   collective {t['collective_s']:10.4f}s   peak/dev "
          f"{peak / 1e9:.2f} GB")
    print(f"\n-- top FLOP contributors (of {stats.flops:.3e} total)")
    for c in stats.top_flops(top):
        print(f"  {c.flops:9.3e}  x{c.multiplicity:<6.0f} {c.shape:34s} "
              f"{c.comp[-40:]:40s} {c.meta[-40:]}")
    print(f"\n-- top HBM-byte contributors (of {stats.hbm_bytes:.3e} total)")
    for c in stats.top_bytes(top):
        print(f"  {c.bytes:9.3e}  x{c.multiplicity:<6.0f} {c.opcode:22s} "
              f"{c.shape:30s} {c.comp[-40:]}")
    print(f"\n-- top collectives (wire model, of "
          f"{stats.wire_bytes_total:.3e} total)")
    for c in stats.top_collectives(top):
        print(f"  {c.wire_bytes:9.3e}  x{c.multiplicity:<6.0f} "
              f"{c.kind:20s} buf={c.result_bytes:.2e} p={c.group_size} "
              f"{c.site[-40:]}")
    return t


def one_card_shape(shape, batch, seq_len):
    """The cell's shape cut to one card."""
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(name=f"{shape.name}_1card", kind=shape.kind,
                       seq_len=seq_len or shape.seq_len,
                       global_batch=batch or shape.global_batch)


def dry_run_one_card(arch, cfg, shape, mode):
    """The single-device cell on fake tensors: (stats, peak bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch import dryrun
    one = MeshConfig(shape=(1, 1), axis_names=("data", "model"))
    with dryrun.fake_world(1), FakeTensorMode():
        cell = dryrun.lower_cell(arch, shape, "single", mode, cfg=cfg,
                                 mesh_cfg=one)
        counter, memory, _, _ = dryrun.run_cell(cell)
    return counter.stats, memory["peak_estimate_bytes"]


def _timed_dry_run(arch, cfg, shape, mode):
    """``dry_run_one_card`` and its seconds (a worker process's job)."""
    t0 = time.time()
    stats, peak = dry_run_one_card(arch, cfg, shape, mode)
    return stats, peak, time.time() - t0


def _fill_context(state, n: int):
    """A decode cache that holds ``n`` positions: every ring slot's
    position set and the next index ``n`` (values stay zero: the step's
    work does not depend on them)."""
    import torch
    if isinstance(state, dict):
        if "pos" in state and "index" in state:
            L = state["pos"].shape[-1]
            state["pos"].copy_(torch.arange(L, dtype=state["pos"].dtype,
                                            device=state["pos"].device)
                               .expand_as(state["pos"]))
            state["index"].fill_(n)
        for v in state.values():
            _fill_context(v, n)


def _measure(torch, step, steps, wrappers):
    """One warm-up step, ``steps`` timed ones (host clock, synchronised),
    one under ``torch.profiler``: wall per step, device time by kernel,
    busy share, launches, peak memory."""
    with torch.no_grad():
        step()                                   # warm-up: kernels built
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        launches = {k: w.launches // steps for k, w in wrappers.items()}
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e6, e.count, e.key))
    busy = sum(k[0] for k in kernels)
    gemm = sum(k[0] for k in kernels
               if any(m in k[2].lower() for m in GEMM_MARKS))
    return {"wall_s": wall, "profiled_wall_s": prof_wall,
            "device_busy_s": busy, "busy_share": busy / prof_wall,
            "kernel_launches": sum(k[1] for k in kernels),
            "gemm_share": gemm / busy if busy else None,
            "launches": launches, "peak_bytes": peak,
            "by_kernel": [{"name": n[:120], "label": kernel_label(n),
                           "s": s, "launches": c}
                          for s, c, n in sorted(kernels, reverse=True)],
            "card": torch.cuda.get_device_name(0)}


def card_run(cfg, shape, *, seed: int = 0):
    """The cell on one card (random weights from ``seed``): with the
    kernels, STEPS timed steps, and for a prefill also with
    ``use_kernels=False`` (one timed step) — the path the dry run counts
    (a decode cell's ``decode_fn`` reaches no kernel, so its one arm is
    both).  Returns (kernels arm, plain arm or None)."""
    import torch
    from repro_torch.models import common, registry
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    if shape.kind == "train":
        raise NotImplementedError(
            "--device cuda profiles prefill and decode cells; a train step "
            "on one card is chip_smoke.py's train phase")
    dev = torch.device("cuda", torch.cuda.current_device())
    bundle = registry.build(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cd = common.torch_dtype(cfg.compute_dtype)
    params = bundle.init_params(gen, device=dev, dtype=cd)
    B, S = shape.global_batch, shape.seq_len
    wrappers = _wrappers()
    if shape.kind == "decode":
        state = bundle.init_decode_state(B, S, device=dev)
        _fill_context(state, S - 1)
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                               device=dev, dtype=torch.int32)
        # the index moves on step by step; the work does not
        return _measure(torch, lambda: bundle.decode_fn(params, tokens,
                                                        state),
                        STEPS, wrappers), None
    specs = bundle.prefill_input_specs(shape)
    inputs = {k: (torch.randint(0, cfg.vocab_size, tuple(v.shape),
                                generator=gen, device=dev, dtype=v.dtype)
                  if not v.dtype.is_floating_point else
                  torch.randn(tuple(v.shape), generator=gen, device=dev,
                              dtype=v.dtype))
              for k, v in specs.items()}
    arms = [_measure(torch, lambda k=k: bundle.prefill_fn(
        params, **inputs, use_kernels=k), n, wrappers)
        for k, n in ((True, STEPS), (False, 1))]
    return arms[0], arms[1]


def _print_arm(what, real, t, peak, top):
    predicted = max(t.values())
    print(f"\n-- on the card ({real['card']}), {what}")
    print(f"step wall {real['wall_s'] * 1e3:.2f} ms vs predicted "
          f"{predicted * 1e3:.2f} ms (compute {t['compute_s'] * 1e3:.2f}, "
          f"memory {t['memory_s'] * 1e3:.2f}); device busy "
          f"{real['device_busy_s'] * 1e3:.2f} ms = "
          f"{100 * real['busy_share']:.1f}% of the profiled step's wall; "
          f"{real['kernel_launches']} kernel launches")
    print(f"peak {real['peak_bytes'] / 1e9:.2f} GB "
          f"(max_memory_allocated) vs dry run {peak / 1e9:.2f} GB")
    print(f"hand-written kernel launches a step: "
          f"{ {k: v for k, v in real['launches'].items() if v} or 'none'}")
    for k in real["by_kernel"][:top]:
        print(f"  {100 * k['s'] / max(real['device_busy_s'], 1e-12):5.1f}% "
              f"{k['s'] * 1e3:9.3f} ms {k['launches']:6d}x "
              f"{k['label']:8s} {k['name'][:90]}")
    real["by_kernel"] = real["by_kernel"][:top]


def main(argv=None):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--mode", default="paper")
    dryrun.add_override_flags(ap)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--device", default=None, choices=["cuda"],
                    help="also run the cell, cut to one card, on the card")
    ap.add_argument("--batch", type=int, default=None,
                    help="--device cuda: the cell's batch on one card")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="--device cuda: the cell's sequence length")
    args = ap.parse_args(argv)
    overrides = dryrun.parse_overrides(args)
    shape = get_shape(args.shape)
    mode = args.mode if shape.kind == "train" else "serve"

    if args.device != "cuda":
        rec, stats, _ = dryrun.analyze_cell(args.arch, args.shape, args.mesh,
                                         mode, overrides=overrides or None)
        t = print_dry_run(f"{args.arch} {args.shape} {args.mesh} {mode} "
                          f"overrides={overrides} (rank 0 of "
                          f"{rec['devices']})", stats,
                          rec["memory"]["peak_estimate_bytes"], args.top)
        print(json.dumps({"cell": [args.arch, args.shape, args.mesh, mode],
                          "predicted": t, "memory": rec["memory"]}))
        return

    refused = [k for k in dryrun.MESH_OVERRIDES if k in overrides]
    if refused:
        raise SystemExit(f"profile_cell --device cuda runs one card with no "
                         f"mesh and no train step: {refused} do not apply")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_cell --device cuda: CUDA is not available")
    cfg = dryrun.config_overrides(get_config(args.arch), overrides)
    one = one_card_shape(shape, args.batch, args.seq_len)
    # the dry run (CPU only, fake tensors) in a spawned process of its own,
    # while this one runs the cell on the card
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        t0 = time.time()
        dry = pool.submit(_timed_dry_run, args.arch, cfg, one, mode)
        real, plain = card_run(cfg, one)
        stats, peak, dry_s = dry.result()
    t = print_dry_run(f"{args.arch} {one.kind} batch {one.global_batch} x "
                      f"{one.seq_len}, {cfg.num_layers} layers, one card "
                      f"(dry run {dry_s:.1f} s, beside the card run; "
                      f"{time.time() - t0:.1f} s both)", stats, peak,
                      args.top)
    _print_arm("with the kernels", real, t, peak, args.top)
    if plain is not None:
        _print_arm("use_kernels=False (the path the dry run counts)", plain,
                   t, peak, args.top)
    print(json.dumps({"cell": [args.arch, one.kind, one.global_batch,
                               one.seq_len, cfg.num_layers],
                      "predicted": {**t, "step_s": max(t.values()),
                                    "peak_bytes": peak,
                                    "dot_flops": stats.dot_flops,
                                    "fp32_flops": stats.fp32_flops,
                                    "hbm_bytes": stats.hbm_bytes},
                      "dry_run_s": dry_s, "measured": real,
                      "measured_plain": plain}))


if __name__ == "__main__":
    main()
