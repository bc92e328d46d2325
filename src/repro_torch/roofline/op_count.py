"""Dispatch-mode op counter: matmul / convolution FLOPs, HBM bytes,
collectives and the live-bytes high-water mark of a function run on fake
(or meta) tensors.

The port's counterpart of ``src/repro/roofline/hlo_parse.py``.  The JAX
package lowers a cell and reads the post-SPMD HLO text, weighting each
``while`` body by its trip count.  The port runs eager, so there is no
program to parse: ``OpCounter`` is a ``TorchDispatchMode`` that sees every
ATen op the function issues, loops unrolled as they run, so every
iteration is counted as it happens (``while_trip_counts`` stays empty).
Run under ``FakeTensorMode`` nothing is computed or allocated; the counts
are per device (the rank's local shards) as in the reference.

  * ``dot_flops``   — ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` / ``mv`` /
                      ``dot`` (what ``matmul``, ``einsum`` and ``linear``
                      decompose to before they reach the mode): 2 x M x N
                      x K;
  * ``conv_flops``  — ``convolution``: 2 x prod(output) x prod(weight[1:])
                      (transposed: over the input); its backward the same
                      for each gradient it computes;
  * ``fp32_flops``  — the part of both computed in fp32: on the H100 with
                      TF32 off (the port's setting) those run on the CUDA
                      cores, at a fifteenth of the bf16 tensor-core rate,
                      and the roofline prices them apart;
  * ``hbm_bytes``   — every op that is not a view: each tensor operand
                      read once and each result written once (a
                      broadcast dim read once).  The TPU's
                      fusion whitelist (``hlo_parse._BYTES_OPS``) does not
                      carry over: eager PyTorch launches one kernel per
                      op, and each one does touch HBM, so every op counts.
                      In-place ops read and write their target (pure
                      writes — ``copy_``, ``fill_``, ``zero_`` — only
                      write it); scatter-like writes (``index_put_``,
                      ``index_copy_``, ...) count the values written, not
                      the whole target, and gather-like reads
                      (``embedding``, ``index_select``, ``gather``,
                      ``index``) the rows read, not the whole table;
                      allocations (``empty*``) count nothing;
  * ``collectives`` — the ``c10d`` ops ``torch.distributed`` issues: kind,
                      per-device buffer bytes (the result's: the gathered
                      tensor of an all-gather, the shard of a
                      reduce-scatter), the group size read from the op's
                      process-group argument, and ring-model wire bytes
                      with ``hlo_parse``'s formulas;
  * ``peak_bytes``  — the high-water mark of live tensor storage created
                      under the mode (fake storages included), each
                      storage counted once while any tensor holds it.

Contributors name the port function that issued each op (the innermost
``repro_torch`` frame, else the innermost caller outside torch; in a
backward pass the autograd node too) and aggregate by (function, op,
result shape), with the count in ``multiplicity``.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    multiplicity: float = 1.0
    site: str = ""

    @property
    def wire_bytes(self) -> float:
        """Ring-model per-device bytes on the wire (x multiplicity)."""
        p = max(self.group_size, 2)
        n = self.result_bytes
        if self.kind == "all-reduce":
            per = 2.0 * n * (p - 1) / p
        elif self.kind == "all-gather":
            per = n * (p - 1) / p
        elif self.kind == "reduce-scatter":
            per = n * (p - 1)
        elif self.kind == "all-to-all":
            per = n * (p - 1) / p
        else:                              # broadcast, send / recv
            per = float(n)
        return per * self.multiplicity


@dataclass
class Contributor:
    comp: str                 # the port function that issued the op
    opcode: str
    shape: str
    multiplicity: float
    flops: float = 0.0
    bytes: float = 0.0
    meta: str = ""


@dataclass
class ModuleStats:
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    fp32_flops: float = 0.0      # the part of both with fp32 operands
    hbm_bytes: float = 0.0
    collectives: List[CollectiveOp] = field(default_factory=list)
    while_trip_counts: List[int] = field(default_factory=list)
    contributors: List[Contributor] = field(default_factory=list)

    def top_flops(self, n=15):
        return sorted((c for c in self.contributors if c.flops),
                      key=lambda c: -c.flops)[:n]

    def top_bytes(self, n=15):
        return sorted((c for c in self.contributors if c.bytes),
                      key=lambda c: -c.bytes)[:n]

    def top_collectives(self, n=15):
        return sorted(self.collectives, key=lambda c: -c.wire_bytes)[:n]

    @property
    def flops(self) -> float:
        return self.dot_flops + self.conv_flops

    @property
    def wire_bytes_total(self) -> float:
        return sum(c.wire_bytes for c in self.collectives)

    def wire_bytes_by_group(self) -> Dict[int, float]:
        """Wire bytes by group size (the analysis prices a group within a
        node at NVLink's rate, a wider one at InfiniBand's)."""
        out: Dict[int, float] = defaultdict(float)
        for c in self.collectives:
            out[c.group_size] += c.wire_bytes
        return dict(out)

    def collective_summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0.0, "buffer_bytes": 0.0, "wire_bytes": 0.0})
        for c in self.collectives:
            out[c.kind]["count"] += c.multiplicity
            out[c.kind]["buffer_bytes"] += c.result_bytes * c.multiplicity
            out[c.kind]["wire_bytes"] += c.wire_bytes
        return {k: dict(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Op classes
# ---------------------------------------------------------------------------

_NO_BYTES = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten._unsafe_view.default,
             aten.lift_fresh.default, aten.set_.source_Storage_storage_offset}
_PURE_WRITES = {"copy_", "fill_", "zero_", "normal_", "uniform_",
                "bernoulli_", "random_", "exponential_"}
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
             "index_fill_", "scatter_", "scatter_add_", "scatter_reduce_",
             "masked_scatter_", "masked_fill_"}
_GATHERS = {"embedding", "index_select", "gather", "index"}

#: the c10d ops the port's ``torch.distributed`` calls dispatch to -> kind;
#: the first argument holds the result (the tensors reduced or broadcast
#: in place, the gathered outputs, the reduce-scatter's shard)
_COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                "_allgather_base_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "broadcast_": "broadcast"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span: a broadcast (stride-0) dim is
    read once, not once a row."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _shape(x) -> str:
    ts = list(_tensors(x))
    if not ts:
        return "()"
    t = ts[0]
    return f"{str(t.dtype).split('.')[-1]}{list(t.shape)}"


def _group_size(func, args, kwargs) -> int:
    """The size of the op's process group (its ``process_group``
    argument, a boxed ``ProcessGroup``)."""
    from torch._C._distributed_c10d import ProcessGroup
    names = [a.name for a in func._schema.arguments]
    i = names.index("process_group")
    pg = kwargs.get("process_group", args[i] if i < len(args) else None)
    return ProcessGroup.unbox(pg).size()


def _site() -> Tuple[str, str]:
    """(function, "file:line") of the innermost port frame issuing the op
    (else the innermost caller outside torch and this module)."""
    f = sys._getframe(2)
    fallback = None
    while f is not None:
        fn = f.f_code.co_filename
        if "/torch/" not in fn and not fn.endswith("op_count.py"):
            if "/repro_torch/" in fn:
                tail = fn.split("/repro_torch/")[-1]
                return (f"{tail[:-3].replace('/', '.')}.{f.f_code.co_name}",
                        f"{tail}:{f.f_lineno}")
            if fallback is None:
                fallback = (f.f_code.co_name,
                            f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}")
        f = f.f_back
    return fallback or ("?", "")


def _mm_flops(name, args) -> float:
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm", "addbmm"):
        a, b = args[1], args[2]
    elif name == "mv":
        return 2.0 * args[0].numel()
    elif name == "addmv":
        return 2.0 * args[1].numel()
    elif name == "dot":
        return 2.0 * args[0].numel()
    else:
        return 0.0
    return 2.0 * a.numel() * b.shape[-1]


def _conv_flops(x, w, out, transposed) -> float:
    per = 1
    for d in w.shape[1:]:
        per *= d
    return 2.0 * (x.numel() if transposed else out.numel()) * per


# ---------------------------------------------------------------------------
# The mode
# ---------------------------------------------------------------------------

class OpCounter(TorchDispatchMode):
    """Counts what runs inside ``with OpCounter() as c:`` into ``c.stats``
    (``ModuleStats``) and tracks ``c.peak_bytes``.  Enter it inside
    ``FakeTensorMode`` so it sees each op before the fake kernel runs it."""

    def __init__(self):
        super().__init__()
        self.stats = ModuleStats()
        self._contrib: Dict[tuple, Contributor] = {}
        self._coll: Dict[tuple, CollectiveOp] = {}
        self._storages: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.live_bytes = 0          # an upper bound until pruned
        self.peak_bytes = 0

    # -- memory --------------------------------------------------------------

    def track(self, out):
        """Count the storages of ``out`` (tensors, or nested lists of them)
        as live from now on: what a step finds allocated on entry."""
        grew = False
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            old = self._storages.get(key)
            if old is not None and not old[0].expired():
                continue
            if old is not None:
                self.live_bytes -= old[1]
            n = st.nbytes()
            self._storages[key] = (StorageWeakRef(st), n)
            self.live_bytes += n
            grew = True
        if grew and self.live_bytes > self.peak_bytes:
            self._prune()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _prune(self):
        dead = [k for k, (ref, _) in self._storages.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self._storages.pop(k)[1]

    def live_now(self) -> int:
        self._prune()
        return self.live_bytes

    # -- ops -------------------------------------------------------------------

    def _add(self, kind_flops: str, opcode, out, flops=0.0, nbytes=0.0):
        comp, where = _site()
        node = torch._C._current_autograd_node()
        meta = f"{where} {node.name()}" if node is not None else where
        key = (comp, opcode, _shape(out), meta)
        c = self._contrib.get(key)
        if c is None:
            c = Contributor(comp=comp, opcode=opcode, shape=key[2],
                            multiplicity=0.0, meta=meta)
            self._contrib[key] = c
            self.stats.contributors.append(c)
        c.multiplicity += 1
        c.flops += flops
        c.bytes += nbytes
        if kind_flops == "dot":
            self.stats.dot_flops += flops
        elif kind_flops == "conv":
            self.stats.conv_flops += flops
        if flops and any(t.dtype == torch.float32 for t in _tensors(out)):
            self.stats.fp32_flops += flops
        self.stats.hbm_bytes += nbytes

    def _collective(self, name, func, args, kwargs):
        kind = _COLLECTIVES[name]
        n = sum(_nbytes(t) for t in _tensors(args[0]))
        p = _group_size(func, args, kwargs)
        comp, _ = _site()
        key = (kind, n, p, comp)
        c = self._coll.get(key)
        if c is None:
            c = CollectiveOp(kind=kind, result_bytes=n, group_size=p,
                             multiplicity=0.0, site=comp)
            self._coll[key] = c
            self.stats.collectives.append(c)
        c.multiplicity += 1

    def _bytes(self, func, name, args, kwargs, out) -> float:
        if func in _NO_BYTES or func.is_view:
            return 0.0
        schema = func._schema
        ins = [a for a in list(args) + list(kwargs.values())]
        mutated = [a for a, s in zip(args, schema.arguments)
                   if s.alias_info is not None and s.alias_info.is_write]
        base = name.split(".")[0]
        if base in _SCATTERS:
            rest = [t for a in ins if not any(a is m for m in mutated)
                    for t in _tensors(a)]
            return 2.0 * sum(_nbytes(t) for t in rest)
        if base in _GATHERS:
            idx = [t for a in ins[1:] for t in _tensors(a)]
            res = sum(_nbytes(t) for t in _tensors(out))
            return 2.0 * res + sum(_nbytes(t) for t in idx)
        read = 0
        for a in ins:
            if base in _PURE_WRITES and any(a is m for m in mutated):
                continue
            read += sum(_nbytes(t) for t in _tensors(a))
        written = sum(_nbytes(t) for t in _tensors(out))
        return float(read + written)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d" and name in _COLLECTIVES:
            self._collective(name, func, args, kwargs)
            self.track(out)
            return out
        if ns != "aten":
            return out
        opcode = func.__name__ if hasattr(func, "__name__") else name
        nbytes = self._bytes(func, name, args, kwargs, out)
        if name in ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv",
                    "addmv", "dot"):
            self._add("dot", opcode, out, _mm_flops(name, args), nbytes)
        elif name == "convolution":
            self._add("conv", opcode, out,
                      _conv_flops(args[0], args[1], out, bool(args[6])),
                      nbytes)
        elif name == "convolution_backward":
            g, x, w = args[0], args[1], args[2]
            transposed, mask = bool(args[7]), args[10]
            fl = _conv_flops(x, w, g, transposed) * (int(mask[0])
                                                     + int(mask[1]))
            self._add("conv", opcode, out, fl, nbytes)
        elif nbytes:
            self._add("", opcode, out, 0.0, nbytes)
        self.track(out)
        return out
