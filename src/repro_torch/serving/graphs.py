"""The engine's decode cycles as CUDA graphs.

The JAX engine runs every decode cycle as one jitted ``lax.scan`` over
``decode_steps`` (``src/repro/serving/engine.py``'s four decode scans:
paged and slotted, greedy and sampled; "one fused dispatch per cycle").
Eager PyTorch launches each op of each step from the host; on the card a
CUDA graph is the counterpart of the jitted scan.

A ``DecodeGraphs`` belongs to one engine.  For each kind of cycle it
meets — keyed by pool kind, sampled or greedy, ``decode_steps``, kv dtype
and slot count; within one engine only ``sampled`` varies — it captures
the engine's eager decode body once (the same function the eager loop
runs, so both arms compute the same thing), and afterwards each cycle

  1. copies the cycle's uploaded operands into the graph's static inputs
     (device-to-device copies, ordered on the stream after the uploads);
  2. replays the graph: ``decode_steps`` steps of every layer's launches
     in one graph launch;
  3. clones the static outputs ``stack`` and ``last``: a pipelined engine
     still holds one cycle's ``stack`` while the next cycle replays.

Static inputs: ``toks0`` [slots] int32; the paged pool's ``packed``
[slots, table_width + 2] (page table | pos | limits), or the slotted
pool's ``limits`` and, sampled, ``pos0`` [slots]; ``samp`` [slots, 4] when
sampled.  The pool's buffers (the pages; the slotted state) are written in
place by the graph, and nothing rebinds them while it lives.

Capture.  Before each capture the body runs once for real on the graphs'
stream, so that lazy set-up (cuBLAS workspaces, the kernels' libraries and
split scratch) happens outside the capture.  On the paged pool that
warm-up runs with every slot masked (the all-trash page table, pos 0,
budget 0: it writes only the trash page); the slotted decode writes every
slot's state, so the pool's state is saved before it and written back
after.  Live requests — greedy ones when a sampled graph is first needed,
say — are untouched either way.  A capture that fails raises with its
cause; nothing falls back to the eager loop.

Launch counts: what the kernel wrappers count while capturing goes to the
capture's tally (``kernels/common.py``), which every replay adds.

Memory: the graphs of one engine share one private memory pool; ``close``
releases them (the Session calls it when it drops the engine).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.common import add_launches, capture_launches
from repro_torch.models.common import tree_map, write_tree_


class _Graph:
    """One captured decode cycle: the graph, its static inputs and outputs,
    its kernel launches per replay, and the scratch it holds."""

    __slots__ = ("graph", "inputs", "stack", "last", "launches", "held")

    def __init__(self, graph, inputs, stack, last, capture):
        self.graph = graph
        self.inputs: Dict[str, torch.Tensor] = inputs
        self.stack = stack
        self.last = last
        self.launches = capture.launches
        self.held = capture.held


class DecodeGraphs:
    """The decode graphs of one engine (see the module docstring)."""

    def __init__(self, engine):
        # what the graphs need of the engine (no reference back to it)
        cfg = engine.cfg
        self._kind = (("paged" if engine.paged else "slotted"),)
        self._shape = (cfg.decode_steps, cfg.kv_dtype, cfg.max_batch)
        self._pool = engine.pool
        self._paged = engine.paged
        self._device = engine.device
        self.stream = torch.cuda.Stream(engine.device)
        self.mempool = torch.cuda.graph_pool_handle()
        self._graphs: Optional[Dict[Tuple, _Graph]] = {}
        self.capture_s = 0.0         # warm-ups and captures, host clock
        self.warmups = 0             # real runs of the body before captures
        self.replays = 0

    def __len__(self) -> int:
        return len(self._graphs or {})

    def key(self, sampled: bool) -> Tuple:
        """(pool kind, sampled, decode_steps, kv dtype, slots)."""
        return self._kind + (sampled,) + self._shape

    def run(self, body: Callable, operands: Dict[str, torch.Tensor]):
        """One decode cycle of ``body`` (the engine's eager decode loop) on
        ``operands``: the replay of its graph, captured on first use.
        Returns (stack [decode_steps, slots], last [slots])."""
        if self._graphs is None:
            raise RuntimeError("the engine's decode graphs were released "
                               "(DecodeGraphs.close)")
        key = self.key("samp" in operands)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(key, body, operands)
        for name, t in operands.items():
            g.inputs[name].copy_(t)
        g.graph.replay()
        add_launches(g.launches)
        self.replays += 1
        return g.stack.clone(), g.last.clone()

    def _capture(self, key, body, operands) -> _Graph:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self._device)
        # zeros are the masked operands: trash table, pos 0, budget 0,
        # token 0, greedy sampling rows
        inputs = {n: torch.zeros_like(t) for n, t in operands.items()}
        saved = (None if self._paged
                 else tree_map(lambda t: t.clone(), self._pool.state))
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            body(**inputs)
            if saved is not None:
                write_tree_(self._pool.state, saved)
        cur.wait_stream(self.stream)
        self.warmups += 1
        graph = torch.cuda.CUDAGraph()
        try:
            with capture_launches() as cap, torch.cuda.graph(
                    graph, pool=self.mempool, stream=self.stream):
                stack, last = body(**inputs)
        except RuntimeError as e:
            raise RuntimeError(f"capturing the decode graph {key} failed: "
                               f"{e}") from e
        self.capture_s += time.perf_counter() - t0
        return _Graph(graph, inputs, stack, last, cap)

    def pool_bytes(self) -> Optional[int]:
        """Device bytes the graphs' private memory pool holds (the
        allocator's snapshot), or None where the snapshot does not say."""
        segs = torch.cuda.memory_snapshot()
        if not segs or "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(self.mempool))

    def close(self) -> None:
        """Release every graph (and with the last one the private pool);
        a later ``run`` raises."""
        self._graphs = None
