"""Continuous-batching serving engine with a pipelined submit/retire cycle.

The PyTorch port of the JAX package's engine.  The user supplies a model
config (whose registry bundle declares its decode-path contracts — the
engine dispatches on ``bundle.capabilities()``); the engine owns request
admission, KV management, prefill/decode interleaving and speculative
decoding.  Two pools, chosen as the JAX engine chooses them:

  * paged (a family with a ``KVLayout``, ``kv_layout`` "auto" or "paged"):
    page-granular KV, prefix-cache page sharing (``enable_prefix_cache``),
    chunked prefill and n-gram speculation;
  * slotted (``serving/kvcache.py``; the recurrent families, whose O(1)
    state has no layout, and ``kv_layout="slotted"``): one decode state per
    slot, whole-prompt prefill (bucketed to powers of two where the family
    takes masked tails; exact length for recurrent and ring families), a
    batched decode of every slot at its own position.

User scripts reach it through ``repro_torch.api``'s ``Session.serve`` /
``Session.generate``.

Pipelined event loop (one ``step()`` = one cycle, three phases):

  plan    — pure host decisions, nothing waits on the device: priority
            preemption, admission (prefix-page mapping), chunk sizing +
            page preparation, per-slot decode budgets (``limits``) and lazy
            page growth for the whole decode span.
  submit  — launch the plan on the device: suffix chunks, then ONE decode
            loop covering all ``decode_steps`` for every decodable slot,
            then one batched verify of the cycle's drafts.  Host positions
            advance immediately (deterministic once planned), so the next
            plan can run while this step's launches are still executing.
  retire  — materialise the *previous* cycle's results (the only host <-
            device sync on the untraced path) and emit its tokens in the
            exact order the synchronous engine would have.

With ``pipeline_depth=2`` (default) step N+1 plans and submits while step
N's device work is in flight and retires N afterwards; ``pipeline_depth=1``
retires each cycle right after submitting it.  Greedy output is token-
identical either way.

Differences from the JAX engine, all forced by eager PyTorch:

  * ``jax.lax.scan`` over decode steps becomes a Python loop
    (``_decode_loop`` / ``_decode_slotted``), and on a CUDA device the
    jitted scan's counterpart is a CUDA graph of that loop: each decode
    cycle — either pool, greedy or sampled — is one graph replay
    (``serving/graphs.py``; ``ServeConfig.decode_graphs``, resolved in
    ``decode_graphs``: on for CUDA without a mesh, the eager loop when
    False, on the CPU and on a mesh).  The scan over verify rows stays a
    Python loop, and prefill chunks and verify rows run eagerly.
    ``prefill_compiles`` keeps its meaning as the count of distinct
    prefill shapes (what bucketing bounds).
  * The JAX engine ``vmap``s the slotted decode over slots; here the slots
    are the batch axis of one decode call, each at its own position.
  * Pools are written in place where the JAX engine donated buffers (a
    decode graph writes the same buffers: they are never rebound).
  * Traced mode times device phases by stream events on the card's clock
    (``serving/profiling.py``), resolved after retire has waited for them;
    the JAX engine's traced mode blocks on each phase instead.  Traced or
    not, nothing syncs before retire.
  * Sampled rows draw JAX's threefry bits (``serving/sampling.py``) from
    int64 tensor arithmetic, on the device, with no host sync.

``kv_dtype="int8"`` quantizes the per-head pages (contiguous and ring);
MLA's latent pages and the slotted pool reject it with the JAX package's
errors.

Mesh placement (``mesh_cfg``): one process per mesh device, every rank
running this same engine on the same request stream — the host
scheduler's decisions depend on the stream and on tokens every rank
holds, never on a clock or on rank-local state, so the ranks stay in
lockstep through every collective.  Parameters are placed by the rules
(``launch.sharding.param_rules``; replicated over the data axes) and the
model runs on this rank's shards under its ``models.common.ModelAxis``:
tensor-parallel decode over "model", the vocab-sharded logits gathered
before argmax or sampling.  The paged pool holds this rank's KV heads and
replicates over the data axes (every data rank runs every slot); the
slotted pool puts its slots over the data axes — each data-parallel rank
prefills and decodes its own run of slots, a prefill's first token is
broadcast from its owner, and every decode step's tokens are gathered.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.models import registry
from repro_torch.models.common import (logical_to_mesh, model_axis,
                                       torch_dtype)
from repro_torch.models.moe import held_picks as moe_held_picks
from repro_torch.obs import (INFLIGHT_COUNTER, NULL_TRACER, Tracer,
                             request_track, write_chrome_trace)
from repro_torch.serving.graphs import DecodeGraphs
from repro_torch.serving.kvcache import SlotKVCachePool
from repro_torch.serving.layouts import quantized_layout
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged import PagedKVCachePool, upload
from repro_torch.serving.profiling import device_clock
from repro_torch.serving.sampling import (GREEDY, PACKED_WIDTH,
                                          SamplingParams, pack_params,
                                          sample_tokens)
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.spec import DrafterPool

# stream callback: (request_id, token, done) -> None
StreamFn = Callable[[int, int, bool], None]

#: smallest prefill bucket — below this the pad overhead beats the reuse
_MIN_BUCKET = 16

def _check_two_kind(cfg: ServeConfig) -> None:
    """What a two-kind (hybrid) pool does not have yet, each refused by
    name: a prefix cache over its rings, speculative verify rows on them
    (int8 pages are refused by ``check_kv_dtype``)."""
    if cfg.enable_prefix_cache:
        raise ValueError(
            "enable_prefix_cache=True on the two-kind (hybrid) layout of "
            "windowed and global layers: the pool has no prefix matching "
            "for the windowed layers' rings yet — pass "
            "enable_prefix_cache=False")
    if cfg.enable_spec:
        raise ValueError(
            "enable_spec=True on the two-kind (hybrid) layout of windowed "
            "and global layers: the pool has no speculative verify rows "
            "for the windowed layers' rings yet — pass enable_spec=False")


def resolve_device(device) -> torch.device:
    """The engine's device: ``"cuda"`` by default, and no CPU fallback —
    asking for CUDA on a machine without it raises (tests pass
    ``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on "
            "the CPU (with the kernels' plain PyTorch versions)")
    return dev


def resolve_decode_graphs(choice: Optional[bool], device: torch.device,
                          mesh_cfg) -> bool:
    """``ServeConfig.decode_graphs`` for an engine on ``device``: None
    means CUDA graphs on a CUDA device without a mesh; True where graphs
    cannot run raises, and says why."""
    if choice is None:
        return device.type == "cuda" and mesh_cfg is None
    if choice and mesh_cfg is not None:
        raise ValueError(
            "decode_graphs=True with a mesh: the meshed decode step runs "
            "collectives between the ranks (gloo where ranks share a card, "
            "which a CUDA graph cannot capture; NCCL meshes wait for a "
            "multi-card configuration); pass decode_graphs=None or False")
    if choice and device.type != "cuda":
        raise ValueError(
            f"decode_graphs=True needs a CUDA device (decode cycles are "
            f"CUDA-graph replays), got {device}; pass decode_graphs=None "
            "or False")
    return choice


def bucket_len(n: int, cap: int, *, floor: int = _MIN_BUCKET) -> int:
    """Smallest power-of-two >= n (floored at ``floor``), clamped to the
    cache capacity ``cap`` — every admissible length lands in O(log cap)
    distinct shapes."""
    assert 1 <= n <= cap, (n, cap)
    return min(max(floor, 1 << (n - 1).bit_length()), cap)


class _PrefillJob:
    """Host-side progress of one request's chunked suffix prefill."""

    __slots__ = ("req", "prompt", "done")

    def __init__(self, req: Request, prompt: Tuple[int, ...], done: int):
        self.req = req
        self.prompt = prompt
        self.done = done                  # tokens already cached


class _AdmitPlan:
    """A planned whole-prompt admission: the slotted pool's prefill, or —
    paged, with ``cached_tok`` set — a full hit, where every prompt block
    is mapped from the prefix cache AND the pool remembered the greedy
    next token, so submit launches nothing for it: it just seeds the
    device token chain and the slot decodes this same cycle."""

    __slots__ = ("req", "slot", "prompt", "cached_tok")

    def __init__(self, req: Request, slot: int, prompt: Tuple[int, ...],
                 cached_tok=None):
        self.req = req
        self.slot = slot
        self.prompt = prompt
        self.cached_tok = cached_tok


class _ChunkPlan:
    """One planned suffix chunk (pages already prepared)."""

    __slots__ = ("job", "slot", "start", "chunk", "completes")

    def __init__(self, job: _PrefillJob, slot: int, start: int, chunk: int,
                 completes: bool):
        self.job = job
        self.slot = slot
        self.start = start
        self.chunk = chunk
        self.completes = completes


class _SpecPlan:
    """One planned speculative verify: a slot whose decode row is swapped
    for a single drafted-token verification forward this cycle."""

    __slots__ = ("req", "slot", "drafts", "start", "m")

    def __init__(self, req: Request, slot: int, drafts: Tuple[int, ...],
                 start: int, m: int):
        self.req = req
        self.slot = slot
        self.drafts = drafts              # m drafted token ids
        self.start = start                # pool pos = index of last token
        self.m = m


class _StepPlan:
    """Output of the plan phase: everything submit launches.  The draft
    phase (``_plan_spec``) may swap decode rows for ``specs`` entries
    before submit; after that the plan is frozen."""

    __slots__ = ("admits", "chunks", "rows", "limits", "mask", "specs")

    def __init__(self, admits, chunks, rows, limits, mask):
        self.admits: List[_AdmitPlan] = admits
        self.chunks: List[_ChunkPlan] = chunks
        self.rows: List[Tuple[int, int]] = rows      # (slot, rid), decodable
        self.limits: Dict[int, int] = limits         # slot -> decode budget
        self.mask: Tuple[int, ...] = mask            # slots masked to trash
        self.specs: List[_SpecPlan] = []             # draft-phase verify jobs


class _InFlight:
    """One submitted-but-not-retired cycle: device handles + emission order.

    ``overrides`` are the prefill-origin first tokens (device scalars), in
    the order the synchronous engine would have emitted them; ``stack`` is
    the decode loop's [decode_steps, slots] token matrix; ``specs`` holds
    the cycle's speculative verifies as one triple (plans, emit [N, width],
    nacc [N]).
    """

    __slots__ = ("overrides", "rows", "limits", "stack", "n_steps", "specs")

    def __init__(self, overrides, rows, limits, stack, n_steps, specs=None):
        self.overrides: List[Tuple[int, int, torch.Tensor]] = overrides
        self.rows: List[Tuple[int, int]] = rows
        self.limits: Dict[int, int] = limits
        self.stack = stack                           # device [n_steps, slots]
        self.n_steps = n_steps
        self.specs = specs


class ServingEngine:
    def __init__(self, model_cfg: ModelConfig,
                 serve_cfg: Optional[ServeConfig] = None, *,
                 params=None, mesh_cfg=None, seed: int = 0, clock=None,
                 device=None):
        self.model_cfg = model_cfg
        self.cfg = serve_cfg or ServeConfig()
        self.device = resolve_device(device)
        #: each decode cycle one CUDA-graph replay (else the eager loop)
        self.decode_graphs = resolve_decode_graphs(self.cfg.decode_graphs,
                                                   self.device, mesh_cfg)
        # traced: device phases timed by stream events on the card's clock
        # (no fences: the schedule is the untraced one)
        self.tracer = (Tracer(clock=clock, capacity=self.cfg.trace_capacity,
                              meta={"model": model_cfg.name,
                                    "family": model_cfg.family,
                                    "backend": self.device.type},
                              device_clock=device_clock(self.device))
                       if self.cfg.trace else NULL_TRACER)
        self.bundle = registry.build(model_cfg)
        caps = self.bundle.capabilities()
        if "serve" not in caps:
            raise ValueError(
                f"{model_cfg.name} ({model_cfg.family}) has no serving "
                "decode-path contract (ServeContract); encdec/vlm "
                "frontends need per-request modality inputs")
        cd = torch_dtype(model_cfg.compute_dtype)
        # -- mesh placement (config-selected, transparent to callers)
        self.mesh = None
        self.model_axis = None
        if mesh_cfg is not None:
            from repro_torch.launch import sharding
            from repro_torch.launch.mesh import build_mesh
            self.mesh = build_mesh(mesh_cfg)
            # dp_mode places training state; served weights replicate
            # over the data axes
            rules, sharded = sharding.param_rules(
                dataclasses.replace(mesh_cfg, dp_mode="replicated"),
                model_cfg)
            self.model_axis = sharding.model_axis_for(self.mesh, sharded)
        if params is None:
            # ``seed`` initialises parameters ONLY; sampling randomness is
            # strictly per-request.  Weights are made in the compute dtype,
            # one leaf at a time, so the fp32 master tree never exists.
            gen = torch.Generator(device=self.device).manual_seed(seed)
            if self.mesh is None:
                params = self.bundle.init_params(gen, device=self.device,
                                                 dtype=cd)
            else:
                params = sharding.init_local_params(
                    self.bundle.specs, rules, self.mesh, gen,
                    device=self.device, dtype=cd)
        elif self.mesh is not None:
            # whole weights given (the same on every rank): keep our block
            params = sharding.local_tree(
                _to(params, self.device, cd),
                logical_to_mesh(self.bundle.specs, rules), self.mesh)
        # weights live in the compute dtype, cast once: the values equal
        # cast_tree's per-call cast (both round to nearest even), and the
        # per-call casts in the model entry points become no-ops
        self.params = _to(params, self.device, cd)
        with model_axis(self.model_axis):
            self._build_pool(model_cfg, caps, clock)

    def _build_pool(self, model_cfg, caps, clock):
        """The KV pool and the engine state around it, at this rank's
        shapes (built under the model axis: local KV heads / channels)."""
        self._dp_group, self._dp, self._dp_rank = None, 1, 0

        # -- pool: page-granular when the family has a KVLayout (every
        # paged family of the port declares the prefix contract too);
        # recurrent families' O(1) state has no layout and stays
        # slot-granular, as does kv_layout="slotted"
        self.layout = self.bundle.kv_layout
        self.paged = ("prefix_serve" in caps
                      and self.cfg.kv_layout != "slotted")
        if self.cfg.kv_layout == "paged" and not self.paged:
            raise ValueError(
                f"{model_cfg.name} ({model_cfg.family}/{model_cfg.attn_kind})"
                " has no paged decode path (PagedServeContract / KVLayout); "
                "recurrent families' O(1) state uses the slotted pool "
                "(kv_layout='auto')")
        self._spec_path = ("spec_serve" in caps and self.paged
                           and self.cfg.enable_spec)
        # masked-tail power-of-two bucketing of whole-prompt prefills
        self._bucket_slotted = (self.cfg.prefill_bucket
                                and "bucketed_prefill" in caps)
        if self.paged:
            # windowed families: a page must tile the window
            self.cfg.check_window(self.layout.window)
            # int8 pages: per-head layouts swap their page leaves for int8
            # + per-(page, offset, kv-head) bf16 scales; MLA's latent pages
            # fail here with the JAX package's error naming both knobs
            self.cfg.check_kv_dtype(self.layout)
            self.layout = quantized_layout(self.layout, self.cfg.kv_dtype)
            if self.layout.ring_window:
                _check_two_kind(self.cfg)
            self.pool = PagedKVCachePool(
                self.cfg.max_batch, self.cfg.page_size, self.cfg.max_seq_len,
                lambda: self.bundle.init_decode_state(1, self.cfg.page_size,
                                                      device="meta"),
                num_pages=self.cfg.num_pages, layout=self.layout,
                enable_prefix_cache=self.cfg.enable_prefix_cache,
                tracer=self.tracer, device=self.device)
            # ring chunks are capped at the window: a longer write-then-
            # attend chunk would wrap onto cells its own queries still
            # need; the decode span has the same wrap hazard
            self._chunk_cap = self.layout.max_chunk_tokens(
                self.pool.padded_len)
            self._span_cap = self.layout.max_decode_span(
                self.cfg.decode_steps)
        else:
            # auto-resolved slotted (no KVLayout): the error the explicit
            # kv_layout='slotted' combination gets in validate()
            self.cfg.check_kv_dtype(None)
            # data-parallel slots: each DP rank holds a contiguous run of
            # them when their count divides the DP degree (else every rank
            # holds and runs them all)
            if self.mesh is not None:
                dp = self.mesh.size(self.mesh.dp_axes)
                if dp > 1 and self.cfg.max_batch % dp == 0:
                    self._dp_group = self.mesh.group(self.mesh.dp_axes)
                    self._dp, self._dp_rank = dp, self.mesh.index(
                        self.mesh.dp_axes)
            per = self.cfg.max_batch // self._dp
            self.pool = SlotKVCachePool(
                self.cfg.max_batch,
                lambda: self.bundle.init_decode_state(
                    1, self.cfg.max_seq_len, device=self.device),
                local_slots=(self._dp_rank * per, per))
            self._cache_len = self.cfg.max_seq_len
            self._span_cap = self.cfg.decode_steps
            # host mirror of each slot's next sampling index (= prompt +
            # tokens length): the sampled slotted decode's operand (the
            # paged pool keeps pos itself)
            self._slot_pos = np.zeros((self.cfg.max_batch,), np.int64)

        self.scheduler = Scheduler(self.cfg, tracer=self.tracer)
        moe = model_cfg.moe
        self.metrics = ServingMetrics(
            clock, tracer=self.tracer,
            held_picks=(moe_held_picks if moe is not None
                        and moe.held < moe.num_experts else None))
        self.requests: Dict[int, Request] = {}
        self.results: Dict[int, List[int]] = {}
        self._rid = itertools.count()
        self._prefilling: Dict[int, _PrefillJob] = {}   # slot -> job
        # pipeline state: the one submitted-but-not-retired cycle, the
        # per-request count of its not-yet-emitted tokens, and the device-
        # resident last token per slot (decode feeds decode without a
        # host round-trip)
        self._inflight: Optional[_InFlight] = None
        self._pending: Dict[int, int] = {}              # rid -> tokens in flight
        self._last_toks = torch.zeros((self.cfg.max_batch,),
                                      dtype=torch.int32, device=self.device)
        self.prefill_compiles = 0         # distinct prefill bucket shapes
        self._prefill_shapes: set = set()
        self._drafters = DrafterPool()
        self._spec_wait: set = set()

        # kernels on CUDA, plain versions on the CPU, unless the caller
        # chose (ServeConfig.use_kernels) — one switch for every launch:
        # paged decode steps, prefill chunks and spec-verify rows, and the
        # slotted pool's whole-prompt prefills
        if self.cfg.use_kernels is None:
            self.use_kernels = self.device.type == "cuda"
        else:
            self.use_kernels = self.cfg.use_kernels
        # the decode cycles' CUDA graphs (captured on first use), and the
        # cycles the eager loop ran
        self._graphs = DecodeGraphs(self) if self.decode_graphs else None
        self._eager_cycles = 0

    @property
    def decode_cycles(self) -> int:
        """Decode cycles run: eager loops and graph replays."""
        return self._eager_cycles + (self._graphs.replays
                                     if self._graphs is not None else 0)

    @property
    def decode_steps_run(self) -> int:
        """Decode steps the device ran (each one model step of every slot):
        the cycles', and the graphs' warm-up runs before their captures."""
        warmups = self._graphs.warmups if self._graphs is not None else 0
        return self.cfg.decode_steps * (self.decode_cycles + warmups)

    def close(self) -> None:
        """Release the decode graphs and their private memory pool (the
        Session calls this when it drops the engine); a later graphed
        decode cycle raises."""
        if self._graphs is not None:
            self._graphs.close()

    # ------------------------------------------------------------------
    # Device steps (the JAX engine's jitted scans: Python loops, captured
    # as CUDA graphs on the card)
    # ------------------------------------------------------------------

    def _decode_operands(self, plan: "_StepPlan",
                         sampled: bool) -> Dict[str, torch.Tensor]:
        """One cycle's decode operands on the device: the token chain
        ``toks0``; the paged pool's packed table | pos | limits
        (``packed``), or the slotted pool's ``limits`` and, sampled, next
        sampling indices ``pos0``; a sampled cycle's packed rows
        ``samp``."""
        cfg = self.cfg
        ops = {"toks0": self._last_toks}
        if sampled:
            ops["samp"] = upload(np.stack(
                [pack_params(self.requests[self.pool.owner[s]].sampling
                             if s in self.pool.owner else GREEDY)
                 for s in range(cfg.max_batch)]), self.device)
        if self.paged:
            ops["packed"] = self.pool.decode_operands(plan.limits,
                                                      mask_slots=plan.mask)
        else:
            ops["limits"] = upload(np.asarray(
                [plan.limits.get(s, 0) for s in range(cfg.max_batch)],
                np.int32), self.device)
            if sampled:
                ops["pos0"] = upload(self._slot_pos.astype(np.int32),
                                     self.device)
        return ops

    def _decode(self, ops: Dict[str, torch.Tensor]):
        """One decode cycle on ``ops`` (``_decode_operands``): the replay of
        its CUDA graph, or the eager loop.  Returns (stack, last)."""
        body = self._decode_loop if self.paged else self._decode_slotted
        if self._graphs is not None:
            return self._graphs.run(body, ops)
        self._eager_cycles += 1
        return body(**ops)

    def _decode_loop(self, toks0, packed, samp=None):
        """``decode_steps`` paged decode steps for every slot.  Each slot
        decodes exactly ``limits[slot]`` tokens; past its budget the slot
        freezes and idempotently replays the last in-budget step (same
        token, same position, same K/V write), so no slot writes past its
        prepared span and the rows past the budget are ignored at retire.
        ``packed`` is the pool's [slots, width+2] operand (page table [|
        ring table] | pos | limits); ``samp`` the packed sampling rows of a
        sampled cycle.
        No host sync: this is the body a decode graph captures."""
        tables, pos, limits = self.pool.unpack_operands(packed)
        toks = toks0
        rows = []
        for k in range(self.cfg.decode_steps):
            logits, _ = self.bundle.paged_decode_fn(
                self.params, toks[:, None],
                {"pages": self.pool.pages, **tables, "pos": pos},
                use_kernels=self.use_kernels)
            # the input token sits at pos -> its successor's absolute index
            # is pos + 1; frozen rows replay the same index, same draw
            nxt = (sample_tokens(logits, samp, pos + 1) if samp is not None
                   else torch.argmax(logits, dim=-1).to(torch.int32))
            rows.append(nxt)
            adv = (k + 1) < limits
            toks = torch.where(adv, nxt, toks)
            pos = torch.where(adv, pos + 1, pos)
        stack = torch.stack(rows)
        last = torch.where(limits >= 1, stack[-1], toks0)
        return stack, last

    def _count_prefill_shape(self, toks) -> None:
        """Count a distinct prefill token shape (the JAX engine's compile
        count, which bucketing bounds)."""
        shape = tuple(toks.shape)
        if shape not in self._prefill_shapes:
            self._prefill_shapes.add(shape)
            self.prefill_compiles += 1
            self.metrics.record_prefill_compile()
            self.tracer.instant("prefill.compile", shape=list(shape))

    def _decode_slotted(self, toks0, limits, samp=None, pos0=None):
        """``decode_steps`` decode steps of every slot of the slotted pool
        (slots at their own positions; the pool's state written in place).
        No freeze is needed for state: a slot past its budget only ever
        completes (and is blanked on eviction) or is free (and is
        overwritten by the next insert) — the slots the synchronous engine
        also decoded junk into.  ``samp`` / ``pos0`` are a sampled cycle's
        packed rows and next sampling indices.  No host sync: this is the
        body a decode graph captures."""
        state = self.pool.batched()
        first, n = self.pool.local_slots     # this rank's slots
        mine = slice(first, first + n)
        toks, pos = toks0, pos0
        rows = []
        for k in range(self.cfg.decode_steps):
            logits, _ = self.bundle.decode_fn(self.params,
                                              toks[mine, None], state)
            nxt = (sample_tokens(logits, samp[mine], pos[mine])
                   if samp is not None
                   else torch.argmax(logits, dim=-1).to(torch.int32))
            nxt = self._gather_slots(nxt)
            rows.append(nxt)
            adv = (k + 1) < limits
            toks = torch.where(adv, nxt, toks)
            if samp is not None:
                pos = torch.where(adv, pos + 1, pos)
        stack = torch.stack(rows)
        last = torch.where(limits >= 1, stack[-1], toks0)
        return stack, last

    def _gather_slots(self, x):
        """The data-parallel ranks' slot runs of ``x`` joined (rank order
        is slot order); ``x`` itself without data-parallel slots."""
        if self._dp_group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self._dp)]
        dist.all_gather(parts, x.contiguous(), group=self._dp_group)
        return torch.cat(parts)

    def _slot_owner(self, slot: int) -> int:
        """Global rank of the data-parallel rank holding ``slot`` (at this
        rank's model coordinate)."""
        d = slot // self.pool.local_slots[1]
        return dist.get_global_rank(self._dp_group, d)

    def _bucketed_prompt(self, prompt, cap: int):
        """(tokens [1, S], n_valid_or_None): pad to a power-of-two bucket
        when the family supports masked tails, else the exact length
        (recurrent state and ring caches must not see padding)."""
        n = len(prompt)
        if not self._bucket_slotted:
            return upload(np.asarray(prompt, np.int32)[None, :],
                          self.device), None
        toks = np.zeros((1, bucket_len(n, cap)), np.int32)
        toks[0, :n] = prompt
        return upload(toks, self.device), n

    def _prefill(self, toks, n_valid):
        """Whole-prompt prefill into a single-sequence state sized for one
        slot of ``_cache_len`` tokens."""
        self._count_prefill_shape(toks)
        kw = {} if n_valid is None else {"n_valid": n_valid}
        return self.bundle.serve_prefill_fn(
            self.params, toks, cache_len=self._cache_len,
            use_kernels=self.use_kernels, **kw)

    def _prefill_chunk(self, toks, tables, start: int, n_valid: int):
        """One request's suffix chunk straight into the page pool
        (``tables``: the pool's ``chunk_tables`` of its slot)."""
        self._count_prefill_shape(toks)
        logits, _ = self.bundle.paged_prefill_fn(
            self.params, toks,
            {"pages": self.pool.pages, **tables, "start": start,
             "n_valid": n_valid},
            use_kernels=self.use_kernels)
        return logits

    def _verify(self, specs: List[_SpecPlan], toks, tables):
        """One batched speculative verify: every speculating slot's [last
        token, drafts] row forwards through the all-position head (a loop
        over rows threads the shared pool), then the sampler replays at
        every drafted index and the accepted prefix is counted on the
        device.  Logits row j predicts absolute index ``start + 1 + j``;
        draft j is accepted iff it equals exactly the token the
        non-speculative engine would emit there, so acceptance never
        changes the output stream.  Padding drafts are -1 and
        auto-reject."""
        width = self.cfg.spec_tokens + 1
        logits = []
        for i, sp in enumerate(specs):
            lg, _ = self.bundle.paged_verify_fn(
                self.params, toks[i:i + 1],
                {"pages": self.pool.pages, "page_table": tables[i],
                 "start": sp.start, "n_valid": sp.m + 1},
                use_kernels=self.use_kernels)
            logits.append(lg)
        n = len(specs)
        host = np.zeros((n, PACKED_WIDTH + width - 1 + 1), np.int32)
        host[:, PACKED_WIDTH:-1] = -1
        for i, sp in enumerate(specs):
            host[i, :PACKED_WIDTH] = pack_params(sp.req.sampling)
            host[i, PACKED_WIDTH:PACKED_WIDTH + sp.m] = sp.drafts
            host[i, -1] = sp.start
        dev = upload(host, self.device)
        samp = dev[:, :PACKED_WIDTH]
        drafts = dev[:, PACKED_WIDTH:-1]
        start = dev[:, -1].long()
        idx = start[:, None] + 1 + torch.arange(width, device=self.device)
        rows = samp[:, None, :].expand(n, width, PACKED_WIDTH)
        sampled = any(not sp.req.sampling.greedy for sp in specs)
        emit = sample_tokens(torch.cat(logits), rows.reshape(n * width, -1),
                             idx.reshape(-1), sampled=sampled).reshape(n, width)
        match = (emit[:, :-1] == drafts) & (drafts >= 0)
        nacc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        return emit, nacc

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               priority: int = 0, deadline: Optional[float] = None,
               sampling: Optional[SamplingParams] = None
               ) -> Optional[int]:
        """Queue one request.  Returns its id, or None when the admission
        queue is full (caller sheds load / retries)."""
        prompt = tuple(int(t) for t in prompt)
        max_new = (self.cfg.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"slot capacity max_seq_len={self.cfg.max_seq_len}")
        if sampling is None:
            sampling = GREEDY
        elif not isinstance(sampling, SamplingParams):
            raise TypeError(
                f"sampling must be a SamplingParams, got {type(sampling)}")
        rid = next(self._rid)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                      priority=priority, deadline=deadline,
                      sampling=sampling)
        if not self.scheduler.submit(req):
            self.metrics.record_reject()
            return None
        self.requests[rid] = req
        self.metrics.record_submit(rid)
        self.tracer.begin("queued", track=request_track(rid),
                          prompt_tokens=len(prompt))
        return rid

    # ------------------------------------------------------------------
    # Event loop
    # ------------------------------------------------------------------

    @property
    def busy(self) -> bool:
        return bool(self.scheduler.depth() or self.pool.owner
                    or self._inflight is not None)

    def _emit(self, req: Request, token: int, stream: Optional[StreamFn]):
        first = not req.tokens
        req.tokens.append(token)
        if first:
            self.metrics.record_first_token(req.rid)
        else:
            self.metrics.record_token(req.rid)
        done = self._finished(req, token)
        if stream is not None:
            stream(req.rid, token, done)
        return done

    def _finished(self, req: Request, token: int) -> bool:
        if self.cfg.eos_token >= 0 and token == self.cfg.eos_token:
            return True
        return len(req.tokens) >= req.max_new_tokens

    def _complete(self, slot: int, req: Request):
        self.pool.evict(slot)
        self.results[req.rid] = req.tokens
        self.metrics.record_completion(req.rid)
        rt = request_track(req.rid)
        self.tracer.end("decode", track=rt, tokens=len(req.tokens))
        self.tracer.instant("request.complete", track=rt, rid=req.rid,
                            tokens=len(req.tokens),
                            preempted=req.preempted)

    def _finalize(self, slot: int, req: Request):
        """A retired token finished ``req``.  Normally its slot is evicted;
        if it was preempted after this cycle was submitted, the request is
        a ghost — its in-flight tokens completed it, so it leaves the
        waiting queue without ever being re-admitted."""
        self._drafters.drop(req.rid)
        if self.pool.owner.get(slot) == req.rid:
            self._complete(slot, req)
            return
        self.scheduler.drop(req)
        self.results[req.rid] = req.tokens
        self.metrics.record_completion(req.rid)
        rt = request_track(req.rid)
        self.tracer.end("queued", track=rt)
        self.tracer.instant("request.complete", track=rt, rid=req.rid,
                            tokens=len(req.tokens),
                            preempted=req.preempted)

    # ------------------------------------------------------------------
    # Phase 1: plan (host only — decides, allocates, prepares; no blocking)
    # ------------------------------------------------------------------

    def _plan_admit(self, req: Request, admits: List[_AdmitPlan]) -> bool:
        """Reserve a slot (and pages) for one request; False when the pool
        cannot take it right now (the caller re-queues it)."""
        prompt = req.resume_prompt()
        rt = request_track(req.rid)
        if not self.paged:
            slot = self.pool.alloc(req.rid)
            if slot is None:
                return False
            self.tracer.end("queued", track=rt)
            self.tracer.begin("prefill", track=rt, prompt_tokens=len(prompt))
            admits.append(_AdmitPlan(req, slot, prompt))
            return True
        # map cached prefix pages read-only; the suffix prefills in chunks
        # (the first chunk is planned this same cycle).  The greedy
        # next-token memo only holds for greedy requests
        out = self.pool.alloc_prefix(req.rid, prompt,
                                     use_memo=req.sampling.greedy)
        if out is None:
            return False
        slot, cached = out
        if cached:
            self.metrics.record_prefix_hit(cached)
        self.metrics.record_ring_cells(self.pool.ring_width)
        self.tracer.end("queued", track=rt)
        self.tracer.begin("prefill", track=rt, prompt_tokens=len(prompt),
                          prefix_hit_tokens=cached)
        if cached >= len(prompt):
            admits.append(_AdmitPlan(req, slot, prompt,
                                     self.pool.cached_next_token(prompt)))
        else:
            self._prefilling[slot] = _PrefillJob(req, prompt, cached)
        return True

    def _plan_chunks(self, chunks: List[_ChunkPlan]) -> None:
        """Size one suffix chunk per prefilling slot and prepare its pages.
        A slot whose chunk finishes the prompt joins this same cycle's
        decode rows."""
        for slot in sorted(self._prefilling):
            job = self._prefilling.get(slot)
            if job is None:                 # preempted by an earlier slot's
                continue                    # pressure relief this cycle
            remaining = len(job.prompt) - job.done
            chunk = min(remaining, self.cfg.prefill_chunk_tokens
                        or self._chunk_cap, self._chunk_cap)
            if not self.pool.prepare_chunk(slot, job.done,
                                           job.done + chunk - 1):
                self._relieve_pressure(prefer_not=slot)
                if slot not in self._prefilling or \
                        not self.pool.prepare_chunk(slot, job.done,
                                                    job.done + chunk - 1):
                    continue
            completes = job.done + chunk >= len(job.prompt)
            chunks.append(_ChunkPlan(job, slot, job.done, chunk, completes))
            if completes:
                del self._prefilling[slot]

    def _plan_cycle(self) -> _StepPlan:
        cfg, tr = self.cfg, self.tracer
        # requests with un-retired tokens in flight must not be re-admitted
        # (their resume prompt would miss those tokens)
        skip_rids = frozenset(self._pending)
        # 1. preemption (priority policy only): fires when admission is
        # blocked — no free slot, or too few free pages for the most
        # urgent waiter's prompt (prefix-cache hits shrink that need)
        with tr.span("preempt"):
            if cfg.policy == "priority" and self.scheduler.depth():
                head = self.scheduler.peek()
                blocked = (head.rid not in skip_rids
                           and (self.pool.free_slots == 0
                                or (self.paged
                                    and not self.pool.can_admit_prompt(
                                        head.resume_prompt()))))
                if blocked:
                    running = {s: self.requests[r]
                               for s, r in self.pool.owner.items()
                               if s not in self._spec_wait}
                    for slot, _ in self.scheduler.preemption(running):
                        self._preempt(slot)
        # 2. admission: reserve prefix pages / slots; when the pool declines,
        # EVERY not-yet-admitted popped request goes back (head-of-line
        # blocking, never a silent drop)
        admits: List[_AdmitPlan] = []
        with tr.span("admit"):
            pending = self.scheduler.next_prefills(self.pool.free_slots,
                                                   skip_rids)
            for i, req in enumerate(pending):
                if not self._plan_admit(req, admits):
                    for r in reversed(pending[i:]):
                        self.scheduler.push_front(r)
                    break
        # 2b. chunked prefill: one chunk per mid-prefill slot per cycle
        chunks: List[_ChunkPlan] = []
        if self._prefilling:
            self._plan_chunks(chunks)
        self.metrics.sample_queue_depth(self.scheduler.depth())
        # 3. per-slot decode budgets: exactly the tokens the request may
        # still emit, net of everything in flight and the first token this
        # cycle's own prefill will force
        chunk_done = {c.slot for c in chunks if c.completes}
        override_slots = {a.slot for a in admits} | chunk_done
        limits: Dict[int, int] = {}
        for slot, rid in self.pool.owner.items():
            if slot in self._prefilling:
                continue
            if slot in self._spec_wait:
                limits[slot] = 0            # verify in flight: sit out
                continue
            req = self.requests[rid]
            budget = (req.max_new_tokens - len(req.tokens)
                      - self._pending.get(rid, 0)
                      - (1 if slot in override_slots else 0))
            lim = max(min(budget, cfg.decode_steps, self._span_cap), 0)
            if lim > 0 and slot in chunk_done and self.paged:
                # the chunk's blocks are committed to the prefix index only
                # at submit — a ring rotation planned now would strand them
                # (see PagedKVCachePool.safe_decode_span)
                lim = self.pool.safe_decode_span(slot, lim)
            limits[slot] = lim
        # 4. page growth for the whole span (paged); on starvation preempt
        # until the rest fit
        while self.paged:
            starved = self.pool.ensure_decode_capacity(
                skip=self._prefilling.keys(), steps=limits)
            if not starved:
                break
            if not self._relieve_pressure():
                for s in starved:
                    limits[s] = 0
                break
        self.metrics.sample_kv_bytes(self.pool.kv_bytes_held(),
                                     self.pool.kv_bytes_slotted())
        if self.paged:
            self.metrics.sample_global_pages(self.pool.pages_held)
        # 5. growth preemption may have evicted work planned above — keep
        # only what the current ownership map still stands behind
        admits = [a for a in admits
                  if self.pool.owner.get(a.slot) == a.req.rid]
        chunks = [c for c in chunks
                  if self.pool.owner.get(c.slot) == c.job.req.rid]
        rows = [(s, self.pool.owner[s]) for s in sorted(self.pool.owner)
                if s not in self._prefilling and limits.get(s, 0) > 0]
        mask = tuple(sorted(s for s in self.pool.owner
                            if limits.get(s, 0) <= 0))
        return _StepPlan(admits, chunks, rows,
                         {s: limits[s] for s, _ in rows}, mask)

    # ------------------------------------------------------------------
    # Phase 1b: draft (host n-gram proposals; swaps decode rows for
    # verify jobs)
    # ------------------------------------------------------------------

    def _plan_spec(self, plan: _StepPlan) -> None:
        """Pick decode rows to speculate on and draft their continuations.

        A slot is eligible when the host knows its full token history (no
        un-retired emissions, no override planned this cycle) and the
        drafter proposes at least one token.  Pipelined engines idle a busy
        slot for one cycle (limit 0) when the drafter already holds a
        continuation, so the next plan drafts from complete history."""
        if not self._spec_path or not plan.rows:
            return
        cfg = self.cfg
        override_slots = ({a.slot for a in plan.admits}
                          | {c.slot for c in plan.chunks if c.completes})
        for slot, rid in list(plan.rows):
            if slot in override_slots:
                continue
            req = self.requests[rid]
            pending = self._pending.get(rid, 0)
            if pending:
                if (req.tokens and plan.limits.get(slot, 0) > 0
                        and req.max_new_tokens - len(req.tokens)
                        - pending > 1
                        and self._drafters.propose(
                            rid, req.prompt + tuple(req.tokens), 1)):
                    plan.limits[slot] = 0      # stall: drain, draft next
                continue
            if not req.tokens:
                continue
            budget = req.max_new_tokens - len(req.tokens)
            k = min(cfg.spec_tokens, budget - 1)
            if self.pool.layout.window:
                # ring cells alias position p with p - window: each
                # optimistic verify write clobbers the oldest in-window
                # entry, and a rejection cannot restore it (ring rewind
                # keeps cells).  One draft only ever clobbers the position
                # that has already left every window a later token can
                # attend to, so windowed slots draft 1
                k = 1
            if k < 1:
                continue
            drafts = self._drafters.propose(
                rid, req.prompt + tuple(req.tokens), k)
            if not drafts:
                continue
            m = len(drafts)
            # ring windows: the m+1-token write span must stay
            # rotation-free (verify writes like a chunk, without rotation)
            span = self.pool.safe_decode_span(slot, m + 1)
            if span < 2:
                continue
            if span < m + 1:
                m = span - 1
                drafts = drafts[:m]
            others = [s for s in self.pool.active_slots if s != slot]
            if self.pool.ensure_decode_capacity(skip=others,
                                                steps={slot: m + 1}):
                continue        # page-starved: fall back to plain decode
            plan.specs.append(_SpecPlan(req, slot, drafts,
                                        int(self.pool.pos[slot]), m))
            plan.rows = [r for r in plan.rows if r[0] != slot]
            plan.limits.pop(slot, None)
            plan.mask = tuple(sorted(set(plan.mask) | {slot}))

    # ------------------------------------------------------------------
    # Phase 2: submit (launch the plan; advance host positions; no sync)
    # ------------------------------------------------------------------

    def _set_tok(self, slot: int, tok) -> None:
        self._last_toks[slot] = tok

    def _first_token(self, req: Request, logits, prompt_len: int):
        """The prefill-origin first token, left on the device."""
        if req.sampling.greedy:
            return torch.argmax(logits[0]).to(torch.int32)
        return sample_tokens(
            logits, upload(pack_params(req.sampling)[None], self.device),
            torch.tensor([prompt_len], device=self.device))[0]

    def _submit(self, plan: _StepPlan) -> Optional[_InFlight]:
        cfg, tr = self.cfg, self.tracer
        overrides: List[Tuple[int, int, torch.Tensor]] = []
        for a in plan.admits:
            rt = request_track(a.req.rid)
            if a.cached_tok is not None:
                # full-hit fast path: pages mapped read-only at plan, next
                # token remembered from an earlier identical prefill —
                # nothing to launch beyond seeding the token chain
                tok = a.cached_tok
            else:
                # slotted: whole-prompt prefill, its state copied into the
                # slot — by the data-parallel rank holding the slot, which
                # broadcasts the first token to the others
                toks, n_valid = self._bucketed_prompt(a.prompt,
                                                      self._cache_len)
                tok = torch.zeros((), dtype=torch.int32, device=self.device)
                if self.pool.holds(a.slot):
                    with tr.device_span("prefill.device",
                                        tokens=len(a.prompt),
                                        bucket=int(toks.shape[1])):
                        logits, state = self._prefill(toks, n_valid)
                        self.pool.insert_at(a.slot, state)
                    tok = self._first_token(a.req, logits, len(a.prompt))
                if self._dp_group is not None:
                    tok = tok.reshape(1).clone()
                    dist.broadcast(tok, src=self._slot_owner(a.slot),
                                   group=self._dp_group)
                    tok = tok[0]
                self.metrics.record_prefill(len(a.prompt))
                self._slot_pos[a.slot] = len(a.prompt) + 1
            self._set_tok(a.slot, tok)
            overrides.append((a.req.rid, a.slot, tok))
            tr.end("prefill", track=rt)
            tr.begin("decode", track=rt)
        for c in plan.chunks:
            job = c.job
            width = (bucket_len(c.chunk, self.pool.padded_len)
                     if cfg.prefill_bucket else c.chunk)
            ctoks = np.zeros((1, width), np.int32)
            ctoks[0, :c.chunk] = job.prompt[c.start:c.start + c.chunk]
            rt = request_track(job.req.rid)
            with tr.span("prefill.chunk", track=rt, chunk=c.chunk,
                         bucket=width, start=c.start):
                with tr.device_span("prefill.device", tokens=c.chunk,
                                    bucket=width):
                    logits = self._prefill_chunk(
                        upload(ctoks, self.device),
                        self.pool.chunk_tables(c.slot), c.start, c.chunk)
            self.metrics.record_prefill(c.chunk)
            job.done = c.start + c.chunk
            # register fully-written blocks right away: requests admitted
            # next cycle can already share this prefix (stream order makes
            # the pages valid before any reader launches)
            self.pool.commit_prefix(c.slot, job.prompt[:job.done])
            if c.completes:
                tok = self._first_token(job.req, logits, len(job.prompt))
                if job.req.sampling.greedy:
                    # remember (prompt -> next token): a repeat of this exact
                    # prompt skips prefill entirely (full-hit fast path)
                    self.pool.cache_next_token(job.prompt, tok)
                self._set_tok(c.slot, tok)
                overrides.append((job.req.rid, c.slot, tok))
                tr.end("prefill", track=rt)
                tr.begin("decode", track=rt)
        stack = None
        if plan.rows:
            # all-greedy cycles take the plain argmax loop; any sampled row
            # routes the whole cycle through the sampler, whose greedy rows
            # still lower to argmax
            sampled = any(not self.requests[rid].sampling.greedy
                          for _, rid in plan.rows)
            # the span holds the operand uploads and the graph launch
            with tr.device_span("decode.device", steps=cfg.decode_steps,
                                rows=len(plan.rows), sampled=sampled):
                stack, self._last_toks = self._decode(
                    self._decode_operands(plan, sampled))
            # host positions are deterministic once planned — advance now
            # so the next plan overlaps the in-flight device step
            if self.paged:
                self.pool.advance(steps=plan.limits)
            else:
                for slot, _ in plan.rows:
                    self._slot_pos[slot] += plan.limits[slot]
        specs = None
        if plan.specs:
            width = cfg.spec_tokens + 1
            toks = np.zeros((len(plan.specs), width), np.int32)
            for i, sp in enumerate(plan.specs):
                toks[i, 0] = sp.req.tokens[-1]
                toks[i, 1:1 + sp.m] = sp.drafts
            tables = [upload(self.pool.tables[sp.slot], self.device)
                      for sp in plan.specs]
            total = sum(sp.m + 1 for sp in plan.specs)
            with tr.device_span("verify.device", tokens=total,
                                rows=len(plan.specs)):
                emit, nacc = self._verify(plan.specs,
                                          upload(toks, self.device), tables)
            for sp in plan.specs:
                # optimistic host advance over the whole drafted span;
                # retire rewinds past the first mismatch
                self.pool.advance(steps={sp.slot: sp.m + 1})
                self._spec_wait.add(sp.slot)
                self._pending[sp.req.rid] = (self._pending.get(sp.req.rid, 0)
                                             + sp.m + 1)
            specs = (list(plan.specs), emit, nacc)
        for rid, _, _ in overrides:
            self._pending[rid] = self._pending.get(rid, 0) + 1
        for slot, rid in plan.rows:
            self._pending[rid] = self._pending.get(rid, 0) + plan.limits[slot]
        if not overrides and stack is None and specs is None:
            return None
        return _InFlight(overrides, plan.rows, plan.limits, stack,
                         cfg.decode_steps, specs)

    # ------------------------------------------------------------------
    # Phase 3: retire (materialise the previous cycle; emit in sync order)
    # ------------------------------------------------------------------

    def _dec_pending(self, rid: int, n: int) -> None:
        if n <= 0:
            return
        left = self._pending.get(rid, 0) - n
        if left > 0:
            self._pending[rid] = left
        else:
            self._pending.pop(rid, None)

    def _retire(self, inf: _InFlight, stream: Optional[StreamFn]) -> None:
        stack = inf.stack.cpu().numpy() if inf.stack is not None else None
        emitted: List[int] = []
        for rid, slot, tok in inf.overrides:
            if rid in self.results:
                continue
            req = self.requests[rid]
            emitted.append(rid)
            if self._emit(req, int(tok), stream):
                self._finalize(slot, req)
        # decode rows emit step-major / slot-minor; rows past a slot's
        # budget or past an EOS cut are speculative device output
        for k in range(inf.n_steps):
            for slot, rid in inf.rows:
                if k >= inf.limits.get(slot, 0) or rid in self.results:
                    continue
                req = self.requests[rid]
                emitted.append(rid)
                self.metrics.record_decode_token()
                if self._emit(req, int(stack[k, slot]), stream):
                    self._finalize(slot, req)
        # speculative verifies: one host transfer each for accept counts and
        # emitted rows; rewind each slot past its first mismatch and emit
        # accepted drafts + the correction token
        if inf.specs is not None:
            sps, emit_dev, nacc_dev = inf.specs
            emit_all = emit_dev.cpu().numpy()
            nacc_all = nacc_dev.cpu().numpy()
            for i, sp in enumerate(sps):
                req, slot = sp.req, sp.slot
                self._spec_wait.discard(slot)
                self._dec_pending(req.rid, sp.m + 1)
                nacc = int(nacc_all[i])
                self.metrics.record_spec(sp.m, nacc)
                if (self.pool.owner.get(slot) != req.rid
                        or req.rid in self.results):
                    continue    # defensive: spec slots are never preempted
                emit = emit_all[i]
                new_pos = sp.start + 1 + nacc   # last accepted index
                self.pool.rewind(slot, new_pos)
                self._set_tok(slot, int(emit[nacc]))
                for j in range(nacc + 1):
                    emitted.append(req.rid)
                    self.metrics.record_decode_token()
                    if self._emit(req, int(emit[j]), stream):
                        self._finalize(slot, req)
                        break
        # ghost hygiene: a victim preempted after this cycle was submitted
        # keeps the requeue -> resume gap out of inter-token latency
        owned = set(self.pool.owner.values())
        for rid in emitted:
            if rid not in self.results and rid not in owned:
                self.metrics.drop_itl_baseline(rid)
        for rid, _, _ in inf.overrides:
            self._dec_pending(rid, 1)
        for slot, rid in inf.rows:
            self._dec_pending(rid, inf.limits.get(slot, 0))

    # ------------------------------------------------------------------
    # Preemption helpers
    # ------------------------------------------------------------------

    def _preempt(self, slot: int):
        """Evict a running request and put it back at the queue head; its
        emitted tokens fold into the resume prompt."""
        victim = self.requests[self.pool.owner[slot]]
        self._prefilling.pop(slot, None)
        self.pool.evict(slot)
        self.scheduler.requeue(victim)
        self.metrics.record_preemption(victim.rid)
        rt = request_track(victim.rid)
        self.tracer.end("prefill", track=rt, preempted=True)
        self.tracer.end("decode", track=rt, preempted=True)
        self.tracer.instant("request.preempt", track=rt, rid=victim.rid,
                            preemptions=victim.preempted)
        self.tracer.begin("queued", track=rt, resumed=True)

    def _relieve_pressure(self, prefer_not: Optional[int] = None) -> bool:
        """Preempt the lowest-priority, youngest running request to free
        pages (paged pool only; slots with a verify in flight are never
        victims); False when no candidate is left."""
        candidates = [s for s in self.pool.active_slots
                      if s != prefer_not and s not in self._spec_wait]
        if not candidates:
            candidates = [s for s in self.pool.active_slots
                          if s not in self._spec_wait]
        if not candidates:
            return False
        self._preempt(max(
            candidates,
            key=lambda s: (-self.requests[self.pool.owner[s]].priority,
                           self.pool.owner[s])))
        return True

    # ------------------------------------------------------------------
    # The cycle
    # ------------------------------------------------------------------

    def step(self, stream: Optional[StreamFn] = None) -> bool:
        """One engine cycle; returns True while work remains."""
        tr = self.tracer
        with torch.no_grad(), model_axis(self.model_axis), tr.span("step"):
            with tr.span("step.plan"):
                plan = self._plan_cycle()
            with tr.span("step.draft", rows=len(plan.rows)):
                self._plan_spec(plan)
            with tr.span("step.submit"):
                nxt = self._submit(plan)
                prev, self._inflight = self._inflight, nxt
                if prev is not None or nxt is not None:
                    tr.counter(INFLIGHT_COUNTER,
                               int(prev is not None) + int(nxt is not None))
            if self.cfg.pipeline_depth == 1:
                prev, self._inflight = self._inflight, None
            with tr.span("step.retire", pending=prev is not None):
                if prev is not None:
                    self._retire(prev, stream)
                    tr.counter(INFLIGHT_COUNTER,
                               int(self._inflight is not None))
                    # retire has waited for the cycle's tokens: its device
                    # spans' events are complete
                    tr.resolve()
        return self.busy

    def run(self, stream: Optional[StreamFn] = None) -> Dict[int, List[int]]:
        """Drive the loop until queue, slots and pipeline drain; returns
        rid -> tokens."""
        while self.step(stream):
            pass
        return dict(self.results)

    def save_trace(self, path: str) -> Optional[str]:
        """Write the tracer's ring buffer as a Chrome trace JSON (device
        spans still unresolved resolve after one synchronize); None when
        the engine runs untraced."""
        if not self.tracer.enabled:
            return None
        return write_chrome_trace(self.tracer, path)

    def generate(self, prompts, max_new_tokens: Optional[int] = None,
                 stream: Optional[StreamFn] = None,
                 sampling=None) -> List[List[int]]:
        """Submit ``prompts`` (list of token lists) and run to completion.
        ``sampling`` is one ``SamplingParams`` for every prompt or a
        per-prompt list (None entries mean greedy).  A closed batch larger
        than ``max_queue`` is fed with backpressure — never shed."""
        if sampling is None or isinstance(sampling, SamplingParams):
            per_req = [sampling] * len(prompts)
        else:
            per_req = list(sampling)
            if len(per_req) != len(prompts):
                raise ValueError(
                    f"sampling list length {len(per_req)} != "
                    f"{len(prompts)} prompts")
        rids = []
        for p, sp in zip(prompts, per_req):
            while self.scheduler.depth() >= self.cfg.max_queue:
                self.step(stream)
            rid = self.submit(p, max_new_tokens, sampling=sp)
            if rid is None:
                raise RuntimeError("queue admitted past max_queue")
            rids.append(rid)
        out = self.run(stream)
        return [out[r] for r in rids]


def _to(tree, device, dtype):
    """Move a parameter tree to ``device``, floating leaves to ``dtype``
    (no copy for leaves already there)."""
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)
