"""Configuration dataclasses for the PyTorch port (``repro_torch``).

Every run is described by a ``RunConfig`` = (ModelConfig, ShapeConfig,
MeshConfig).  Model configs for the ten assigned architectures live in
``repro_torch.configs.<arch>``; shape presets in ``repro_torch.configs.shapes``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (token-choice top-k routing)."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_jitter: float = 0.0
    # load-balancing auxiliary loss weight (Switch-style)
    aux_loss_weight: float = 0.01
    # capacity factor for dense one-hot dispatch (einsum-based)
    capacity_factor: float = 1.25
    # router scoring: "softmax" (gates renormalised over the top-k) or
    # "sigmoid" (DeepSeek-V3's: experts chosen on sigmoid(logits) plus a
    # per-expert ``e_score_correction_bias`` leaf when ``correction_bias``,
    # gates the sigmoid scores without it, normalised over the top-k)
    scoring: str = "softmax"
    correction_bias: bool = False
    # the routed sum's multiplier (DeepSeek-V3's routed_scaling_factor)
    routed_scaling: float = 1.0
    # experts whose weights this device holds, the first ``experts_held``
    # of ``num_experts`` (0 = all): one device's share of an expert-
    # parallel deployment.  The router keeps its ``num_experts`` outputs
    # and its top-k; picks of absent experts contribute nothing here
    experts_held: int = 0

    @property
    def held(self) -> int:
        return self.experts_held or self.num_experts


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention configuration."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrence configuration."""
    lru_width: int = 0            # 0 => same as d_model
    conv1d_width: int = 4
    # pattern: how many recurrent blocks per attention block (2 recurrent : 1 local attn)
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    attention_window: int = 2048


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 (Finch) configuration."""
    head_size: int = 64
    decay_lora: int = 64          # rank of data-dependent decay LoRA
    token_shift: bool = True


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper-style) extras; frontend is a stub."""
    num_encoder_layers: int = 4
    encoder_seq_len: int = 1500   # whisper frame count after conv frontend
    frontend: str = "stub"        # precomputed frame embeddings via input_specs()


@dataclass(frozen=True)
class VLMConfig:
    """Vision-language (pixtral-style) extras; vision tower is a stub."""
    num_image_tokens: int = 1024  # precomputed patch embeddings per image
    frontend: str = "stub"


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

ATTN_KINDS = ("full", "swa", "local", "mla", "none")
FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm", "cnn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    attn_kind: str = "full"       # one of ATTN_KINDS
    window: int = 0               # sliding/local attention window (0 = n/a)
    qkv_bias: bool = False
    act: str = "swiglu"           # "swiglu" | "gelu" | "geglu" | "relu"
    norm: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    scale_embed: bool = False     # gemma-style sqrt(d_model) embedding scaling
    norm_eps: float = 1e-6
    # sub-configs (None when not applicable)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # numerics
    param_dtype: str = "float32"  # master weights
    compute_dtype: str = "bfloat16"
    # remat ("none" | "full" | "dots" — checkpoint-dots policy)
    remat: str = "full"
    # traced-attention tile sizes (perf knobs; kernels have their own)
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    # flash-style attention backward: nested remat recomputes the score
    # blocks instead of storing them (kills the dominant HBM term of the
    # traced path; see EXPERIMENTS.md §Perf).  Off by default so the
    # baseline table stays paper-faithful; hillclimb flips it.
    attn_remat: bool = False
    # set True for architectures whose attention is subquadratic / bounded-state,
    # which qualifies them for the long_500k cell.
    subquadratic: bool = False
    # per-layer attention kinds, repeated over the layers: "L" a windowed
    # layer (``attn_kind`` with ``window``), "G" a global one (full
    # attention); "" = every layer ``attn_kind``
    layer_pattern: str = ""
    # per-head RMS norm of q and k before rope (their scales are leaves)
    qk_norm: bool = False
    # "pre": x + f(norm(x)); "post": x + norm(f(x)), no norm on the
    # sublayer's input (EXAONE 4)
    norm_placement: str = "pre"
    # "all" layers rotate q / k, or only the "windowed" ones (the global
    # layers of a layer_pattern then use no positional encoding)
    rope_layers: str = "all"
    # leading layers with a dense feed-forward of their own width before
    # the MoE layers (0 = none; d_ff_dense 0 = d_ff)
    first_dense_layers: int = 0
    d_ff_dense: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def validate(self) -> None:
        assert self.family in FAMILIES, self.family
        assert self.attn_kind in ATTN_KINDS, self.attn_kind
        if self.family == "moe":
            assert self.moe is not None
        if self.attn_kind == "mla":
            assert self.mla is not None
        assert set(self.layer_pattern) <= {"L", "G"}, self.layer_pattern
        if "L" in self.layer_pattern:
            assert self.attn_kind in ("swa", "local") and self.window > 0
        assert self.norm_placement in ("pre", "post"), self.norm_placement
        assert self.rope_layers in ("all", "windowed"), self.rope_layers
        assert 0 <= self.first_dense_layers <= self.num_layers
        if self.moe is not None:
            assert self.moe.scoring in ("softmax", "sigmoid")
            assert 0 <= self.moe.experts_held <= self.moe.num_experts

    def layer_kind(self, i: int) -> str:
        """"L" (windowed) or "G" (global) for layer ``i`` of a
        ``layer_pattern``; "" without one."""
        p = self.layer_pattern
        return p[i % len(p)] if p else ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. embeddings)."""
        from repro_torch.models.registry import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)


# ---------------------------------------------------------------------------
# ShapeConfig — the four assigned input-shape presets
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                     # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    def validate(self) -> None:
        assert self.kind in ("train", "prefill", "decode")


# ---------------------------------------------------------------------------
# MeshConfig + distribution options (the paper's feature knobs)
# ---------------------------------------------------------------------------

ALLREDUCE_STRATEGIES = (
    "fused",          # single flat-bucket psum
    "layerwise",      # paper §III-D.2: ordered, per-layer reduction
    "bucketed",       # size-capped buckets (overlap-friendly)
    "hierarchical",   # intra-pod then inter-pod (topology-aware)
    "reduce_scatter", # beyond-paper ZeRO-1: RS + optimizer + AG
    "compressed",     # beyond-paper: bf16 wire format + fp32 error feedback
)

DP_MODES = ("replicated", "fsdp")


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    # paper-faithful vs beyond-paper parameter placement
    dp_mode: str = "replicated"
    allreduce: str = "layerwise"
    bucket_bytes: int = 32 * 1024 * 1024   # for "bucketed"
    # sharding rule overrides: logical axis -> mesh axis (or None)
    rules_override: Tuple[Tuple[str, Optional[str]], ...] = ()

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def model_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a == "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def validate(self) -> None:
        assert len(self.shape) == len(self.axis_names)
        assert self.dp_mode in DP_MODES
        assert self.allreduce in ALLREDUCE_STRATEGIES


SINGLE_POD = MeshConfig(shape=(16, 16), axis_names=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axis_names=("pod", "data", "model"))


# ---------------------------------------------------------------------------
# ServeConfig — continuous-batching inference engine (repro_torch.serving)
# ---------------------------------------------------------------------------

SERVE_POLICIES = ("fcfs", "priority")
KV_LAYOUTS = ("auto", "paged", "slotted")

# KV page storage dtypes ("fp32" = the family's native compute dtype; "int8"
# = quantized pages + per-row scale leaves).  Mirrors
# repro_torch.serving.layouts.KV_DTYPES — kept literal here so ServeConfig
# construction never imports the serving layer.
KV_DTYPES = ("fp32", "int8")


def floor_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1).  The auto-sizing rule every
    page-size default goes through, so it always satisfies the
    ``enable_prefix_cache`` power-of-two validation below."""
    assert n >= 1, n
    return 1 << (n.bit_length() - 1)


@dataclass(frozen=True)
class ServeConfig:
    """Knobs for the continuous-batching serving engine.

    The decode batch shape is fixed at ``max_batch`` slots (one batched
    decode launch per step); requests are inserted into / evicted
    from KV-cache slots individually (no batch re-prefill).

    KV memory is page-granular for every family with a ``KVLayout``
    (``kv_layout="auto"`` picks paged when the bundle declares one): per-
    head k/v pages for full attention, ring-wrapped window pages for
    sliding-window/local attention (a page must fit and tile the window —
    see ``check_window``), latent ckv/krope pages for MLA.  Pages of
    ``page_size`` tokens are allocated lazily as a request's position
    grows and returned on eviction, so cache bytes held track actual
    sequence lengths instead of ``max_batch x max_seq_len``.  Recurrent
    families (RG-LRU / RWKV: O(1) state per slot — nothing to page) stay
    on the slotted pool.  ``num_pages`` provisions the shared pool
    (0 = worst case ``max_batch * ceil(max_seq_len / page_size)`` + the
    reserved trash page; windowed layouts cap the per-slot worst case at
    ``window // page_size``); under-provisioning oversubscribes memory —
    the engine preempts the youngest request on page pressure.

    Prefill-path knobs (engine-level optimization pass, see
    ``serving/engine.py``):

    * ``enable_prefix_cache`` — paged layout only: requests whose prompt
      shares a page-aligned prefix with previously served prompts map the
      cached pages read-only (copy-on-write on a partially reused last
      page) and prefill just the uncached suffix.  Requires a power-of-two
      ``page_size`` (block hashing chunks prompts at page granularity).
    * ``prefill_bucket`` — pad prefill lengths to powers of two with masked
      tails so the distinct prefill shapes stay O(log max_seq_len)
      instead of one per distinct ``(prompt_len, cache_len)``.
    * ``prefill_chunk_tokens`` — split prefills longer than this into
      chunks run one per engine cycle, interleaved with decode steps, so a
      long prompt no longer stalls running streams' inter-token latency
      (0 = never split).  Paged layout only; the slotted path keeps
      bucketing but prefills whole prompts.
    * ``max_prefills_per_step`` — admission bound: how many *requests* may
      start prefilling per engine cycle (formerly ``prefill_chunk``, which
      remains as a deprecated constructor alias).
    Speculative decoding (``serving/spec.py``; paged layout only):

    * ``enable_spec`` — let the engine draft continuation tokens from each
      request's own history (n-gram prompt lookup) and verify them in one
      paged forward per slot.  Verification replays the engine's own
      sampler at every drafted position, so output is token-identical to
      ``enable_spec=False`` for greedy and sampled requests alike — the
      knob only trades host drafting + one verify forward against the
      decode steps the accepted tokens would have cost.
    * ``spec_tokens`` — maximum draft tokens proposed (and verified) per
      slot per cycle.

    * ``pipeline_depth`` — engine submit/retire pipelining: 2 (default)
      overlaps the next cycle's host planning against the in-flight device
      step (plan N+1 and submit it while N's results are still
      materializing, retire N afterwards); 1 is the synchronous escape
      hatch (every cycle retires before the next plans — what
      ``launch/serve.py --sync`` sets).  Greedy output is token-identical
      either way; depth changes scheduling latency only.

    Observability (``repro_torch.obs``):

    * ``trace`` — record per-phase engine spans, per-request lifecycle
      spans and page-pool cache events into a bounded in-memory ring
      (exportable as a Perfetto-loadable Chrome trace; per-phase seconds
      fold into ``ServingMetrics.summary()``).  Device phases are timed by
      stream events on the card's clock, with no synchronize, so a traced
      engine runs the untraced schedule; the recording costs host time.
      Traced or not, the engine's spans are ``record_function`` ranges
      while a ``torch.profiler`` session is active.
    * ``trace_capacity`` — ring-buffer bound (events); oldest drop first.

    Device dispatch:

    * ``use_kernels`` — the hand-written CUDA kernels (None: on a CUDA
      device) or their plain PyTorch versions.
    * ``decode_graphs`` — every decode cycle as one CUDA-graph replay
      (``serving/graphs.py``): captured once per pool kind, sampled or
      greedy, ``decode_steps``, kv dtype and slot count, then replayed with
      the cycle's operands copied into its static inputs.  None resolves
      to graphs on a CUDA device without a mesh, False to the eager loop
      (the same decode body, one launch at a time); True on the CPU or
      with a mesh raises (the engine resolves it:
      ``ServingEngine.decode_graphs``).  Prefill chunks and speculative
      verify rows run eagerly either way.
    """
    max_batch: int = 8            # decode slots (fixed batched-decode shape)
    max_queue: int = 64           # admission control: reject beyond this
    max_seq_len: int = 256        # per-slot KV-cache capacity (prompt + new)
    max_new_tokens: int = 32      # default generation budget per request
    policy: str = "fcfs"          # "fcfs" | "priority" (priority can preempt)
    # request admissions per engine cycle (None = default 2; the sentinel
    # lets the deprecated alias detect an explicitly-passed value even when
    # it equals the default)
    max_prefills_per_step: Optional[int] = None
    decode_steps: int = 4         # decode steps per cycle between admissions
    pipeline_depth: int = 2       # 2 = async submit/retire overlap, 1 = sync
    eos_token: int = -1           # stop token (-1 disables early stop)
    kv_layout: str = "auto"       # "auto" | "paged" | "slotted"
    # KV page storage dtype: "fp32" keeps the family's native compute dtype;
    # "int8" stores k/v pages quantized (symmetric per-(page, offset,
    # kv-head) bf16 scales as extra pool leaves, widened to fp32 on read,
    # dequant fused into the paged-attention kernels).  Paged per-head layouts only — rejected for
    # MLA (latent rank is contracted) and slotted-only families by
    # check_kv_dtype once the engine knows the layout.
    kv_dtype: str = "fp32"        # "fp32" | "int8" (paged k/v pages only)
    page_size: int = 16           # tokens per KV page (paged layout)
    num_pages: int = 0            # shared page pool size (0 = worst case)
    spec_tokens: int = 4          # max draft tokens per slot per cycle
    enable_spec: bool = True      # n-gram speculative decoding (paged)
    enable_prefix_cache: bool = True   # share prompt-prefix pages (paged)
    prefill_bucket: bool = True        # power-of-two prefill length buckets
    prefill_chunk_tokens: int = 0      # chunked prefill size (0 = whole)
    trace: bool = False                # repro_torch.obs engine tracing
    trace_capacity: int = 1 << 16      # trace ring-buffer bound (events)
    # Hand-written CUDA paged-attention kernels (decode + chunked prefill +
    # verify); the counterpart of the JAX package's ``use_pallas``.  None =
    # auto (kernels on a CUDA device, their plain PyTorch versions on the
    # CPU); True asks for the kernels (a kernel wrapper still takes its
    # plain version for CPU tensors); False forces the plain versions even
    # on CUDA — the comparison arm of ``chip_smoke.py``.
    use_kernels: Optional[bool] = None
    # Each decode cycle (decode_steps steps of every slot, greedy or
    # sampled, either pool) as one CUDA-graph replay — the counterpart of
    # the JAX engine's jitted lax.scan.  None = auto (graphs when the
    # engine's device is CUDA and there is no mesh); False = the eager loop
    # everywhere (the comparison arm of chip_smoke.py); True asks for the
    # graphs and raises on the CPU or with a mesh (the engine checks).
    decode_graphs: Optional[bool] = None
    # deprecated alias for max_prefills_per_step (folded in __post_init__)
    prefill_chunk: Optional[int] = None

    _INT_KNOBS = ("max_batch", "max_queue", "max_seq_len", "max_new_tokens",
                  "max_prefills_per_step", "decode_steps", "pipeline_depth",
                  "num_pages", "page_size", "prefill_chunk_tokens",
                  "spec_tokens", "trace_capacity")

    def __post_init__(self):
        # normalize numpy integer knobs (e.g. max_batch=arr.shape[0]) so
        # equality/hashing used by engine caches sees plain ints
        import numbers
        if self.prefill_chunk is not None:
            import warnings
            if self.max_prefills_per_step is not None \
                    and self.max_prefills_per_step != self.prefill_chunk:
                raise ValueError(
                    f"conflicting knobs: max_prefills_per_step="
                    f"{self.max_prefills_per_step} and its deprecated alias "
                    f"prefill_chunk={self.prefill_chunk} — pass only "
                    "max_prefills_per_step")
            warnings.warn(
                "ServeConfig.prefill_chunk is deprecated; it bounds request "
                "admissions per cycle and is now max_prefills_per_step "
                "(prefill_chunk_tokens is the *token* chunking knob)",
                DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "max_prefills_per_step",
                               self.prefill_chunk)
            object.__setattr__(self, "prefill_chunk", None)
        if self.max_prefills_per_step is None:
            object.__setattr__(self, "max_prefills_per_step", 2)
        for knob in self._INT_KNOBS:
            v = getattr(self, knob)
            if isinstance(v, numbers.Integral) and not isinstance(v, int):
                object.__setattr__(self, knob, int(v))
        # fail at construction, not deep inside PagedKVCachePool / the
        # engine loop: every ServeConfig in the system is valid by existence
        self.validate()

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def validate(self) -> None:
        if self.policy not in SERVE_POLICIES:
            raise ValueError(
                f"policy={self.policy!r} not in {SERVE_POLICIES}")
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(
                f"kv_layout={self.kv_layout!r} not in {KV_LAYOUTS}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} not in {KV_DTYPES}")
        if self.kv_dtype != "fp32" and self.kv_layout == "slotted":
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} requires a paged layout "
                f"(kv_layout='paged' or 'auto'), got kv_layout='slotted': "
                "the slotted pool stores the bundle's native decode state "
                "and never quantizes")
        for knob, least in (("max_batch", 1), ("max_queue", 1),
                            ("max_seq_len", 2), ("max_new_tokens", 1),
                            ("max_prefills_per_step", 1), ("decode_steps", 1),
                            ("page_size", 1), ("num_pages", 0),
                            ("prefill_chunk_tokens", 0), ("spec_tokens", 1),
                            ("trace_capacity", 1)):
            v = getattr(self, knob)
            if not isinstance(v, int) or isinstance(v, bool) or v < least:
                raise ValueError(f"{knob}={v!r} must be an int >= {least}")
        # depths beyond 2 would need per-depth retire queues and buy nothing:
        # one in-flight device step already hides the host plan under it
        if self.pipeline_depth not in (1, 2):
            raise ValueError(
                f"pipeline_depth={self.pipeline_depth!r} must be 1 "
                "(synchronous submit/retire) or 2 (plan the next cycle "
                "while one device step is in flight)")
        for knob in ("enable_prefix_cache", "enable_spec", "prefill_bucket",
                     "trace"):
            if not isinstance(getattr(self, knob), bool):
                raise ValueError(f"{knob}={getattr(self, knob)!r} must be "
                                 "a bool")
        if self.use_kernels is not None \
                and not isinstance(self.use_kernels, bool):
            raise ValueError(
                f"use_kernels={self.use_kernels!r} must be None (auto: "
                "kernels on CUDA only) or a bool")
        if self.decode_graphs is not None \
                and not isinstance(self.decode_graphs, bool):
            raise ValueError(
                f"decode_graphs={self.decode_graphs!r} must be None (auto: "
                "CUDA graphs on a CUDA device without a mesh) or a bool")
        # slotted never pages, so page_size is inert there; "auto" may
        # resolve to paged, so it must satisfy the block-hashing constraint
        if self.enable_prefix_cache and self.kv_layout != "slotted" \
                and self.page_size & (self.page_size - 1):
            raise ValueError(
                f"page_size={self.page_size} must be a power of two when "
                "enable_prefix_cache=True (prefix blocks are hashed at page "
                "granularity)")
        # (max_new_tokens is only the *default* per-request budget; the
        # engine checks prompt+max_new <= max_seq_len per submit, so it may
        # legitimately exceed max_seq_len here)
        if self.page_size > self.max_seq_len:
            raise ValueError(
                f"page_size={self.page_size} exceeds max_seq_len="
                f"{self.max_seq_len}: a single page would never fill — "
                "shrink page_size (the pool rounds capacity up to pages)")
        # a pool smaller than one slot's worth (+ trash page) deadlocks the
        # engine: a lone max-length request could never be placed
        if self.num_pages and self.num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold one max_seq_len "
                f"request (needs >= {self.pages_per_slot + 1} pages: "
                f"{self.pages_per_slot} per slot + the reserved trash page)")

    def check_window(self, window: int) -> None:
        """Model-aware validation for windowed-attention families (the
        engine calls this once it knows the family's ``KVLayout``): ring-
        wrapped window pages must *tile* the window.  Delegates to the
        layout seam's single implementation (imported at call time —
        ``repro_torch.serving`` sits above this module)."""
        if self.kv_layout == "slotted":
            return
        from repro_torch.serving.layouts import check_window_page_size
        check_window_page_size(self.page_size, window)

    def check_kv_dtype(self, layout) -> None:
        """Model-aware validation for quantized KV (the engine calls this
        once it knows the family's ``KVLayout``, matching ``check_window``):
        ``kv_dtype="int8"`` needs a per-head paged layout — MLA latent
        pages and slotted-only families are rejected with an error naming
        both knobs.  Delegates to the layout seam's single implementation
        (imported at call time — ``repro_torch.serving`` sits above this
        module).  ``layout`` is the family's base ``KVLayout`` or None when
        the engine resolved to the slotted pool."""
        from repro_torch.serving.layouts import check_kv_dtype_layout
        check_kv_dtype_layout(self.kv_dtype, layout)

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# RunConfig
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"            # "sgd" | "momentum" | "adagrad" | "adam" | "adamw"
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0        # 0 disables


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=lambda: SINGLE_POD)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    microbatch: int = 0           # 0 => no gradient accumulation

    def validate(self) -> None:
        self.model.validate()
        self.shape.validate()
        self.mesh.validate()
