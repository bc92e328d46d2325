"""Slotted, preallocated decode-state pool for continuous-batching decode.

The port of ``src/repro/serving/kvcache.py``.  The pool holds one decode-state
tree whose leaves are stacked over a leading **slot** axis: ``[slots,
<single-sequence decode state>]``, where the single-sequence state is
exactly what ``ModelBundle.serve_prefill_fn`` returns for a batch-of-1
prompt (GQA ring caches ``k/v [L, 1, Lc, KV, hd]`` with per-layer
``pos [L, Lc]`` / ``index [L]``; RG-LRU ``conv`` / ``h`` and the ring
caches of its attention blocks; RWKV ``x`` / ``s`` / ``cm``).  Because
every slot carries its *own* position leaves, slots decode at ragged
sequence positions.

This pool is the recurrent families' home (RG-LRU / RWKV: O(1) state per
slot, nothing to page) and the forced ``kv_layout="slotted"`` baseline
every paged layout is token-identity-tested against.

Writes are in place: ``insert_at`` copies a prefilled state into its slot,
``evict`` blanks the slot (stale state never leaks into a later tenant),
and ``batched()`` hands the decode step views of the pool, so a decode
writes its new state straight into the slots.  Free-slot bookkeeping is
host-side; the engine maps slot -> request.

On a mesh the slot axis shards over the data-parallel axes
(``pool_pspecs``): every rank keeps the bookkeeping of all slots, and the
device state of its own contiguous run of them (``local_slots``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.models.common import stack_slice, tree_map, write_tree_

#: leaves without the single-sequence batch axis (ring-cache bookkeeping)
_POSITION_LEAVES = ("pos", "index")


def _map_named(fn, tree, name=None):
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def pool_pspecs(pool_structs, *, dp_axes: Tuple[str, ...] = (),
                dp_total: int = 1, model_size: int = 1):
    """Placement tree for a slot pool (leaves ``[slots, <single-sequence
    state>]``, whole-model shapes).

    slot axis (dim 0) -> dp axes when the slot count divides them; k/v
    KV heads, the MLA rank, wkv heads and the RG-LRU width -> "model" when
    divisible (KV heads that do not divide replicate: the port shards
    heads whole).  ``pos``/``index`` leaves replicate except for the slot
    axis itself."""

    def _model(dim: int):
        return "model" if model_size > 1 and dim % model_size == 0 else None

    def rule(name, leaf):
        nd = leaf.ndim
        spec = [None] * nd
        slots = leaf.shape[0] if nd else 1
        if dp_axes and dp_total > 1 and slots % dp_total == 0:
            spec[0] = tuple(dp_axes)
        if name in ("k", "v") and nd == 6:          # [slots,L,1,Lc,KV,hd]
            spec[4] = _model(leaf.shape[4])
        elif name in ("ckv", "krope") and nd == 5:  # [slots,L,1,Lc,R]
            spec[4] = _model(leaf.shape[4])
        elif name == "s" and nd == 6:               # [slots,L,1,H,hd,hd]
            spec[3] = _model(leaf.shape[3])
        elif name == "h" and nd == 4:               # [slots,n,1,W]
            spec[3] = _model(leaf.shape[3])
        elif name == "conv" and nd == 5:            # [slots,n,1,cw-1,W]
            spec[4] = _model(leaf.shape[4])
        return tuple(spec)

    return _map_named(rule, pool_structs)


class SlotKVCachePool:
    """Fixed-shape pool of ``num_slots`` per-sequence decode states.

    ``blank_fn()`` must return the single-sequence (batch=1) decode state a
    fresh slot holds — ``ModelBundle.init_decode_state(1, cache_len,
    device=...)`` — on the pool's device.  The pool allocates once;
    insertion and eviction are per-slot copies, never a batch rebuild, so
    the batched decode shape is constant for the pool's lifetime.
    """

    def __init__(self, num_slots: int, blank_fn: Callable[[], object], *,
                 local_slots: Optional[Tuple[int, int]] = None):
        assert num_slots >= 1
        self.num_slots = num_slots
        #: (first, count): the slots whose state this rank holds (a data-
        #: parallel rank's run); every slot without a mesh
        self.local_slots = local_slots or (0, num_slots)
        self._blank = blank_fn()
        n = self.local_slots[1]
        self.state = tree_map(
            lambda x: x[None].expand((n,) + x.shape).clone(), self._blank)
        self._free: List[int] = list(range(num_slots))
        self.owner: Dict[int, int] = {}      # slot -> request id

    # -- host bookkeeping --------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self.owner)

    def alloc(self, rid: int) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop(0)
        assert slot not in self.owner, f"slot {slot} double-assigned"
        self.owner[slot] = rid
        return slot

    # -- device writes (in place) ------------------------------------------

    def insert_at(self, slot: int, one_state) -> None:
        """Copy a prefilled single-sequence state into an already
        ``alloc``-ed slot — the device half of admission.  A pipelined
        engine allocates in its plan phase (host decision) and copies at
        submit; the one-shot ``insert`` composes both.  A slot another
        rank holds is not written here."""
        if self.holds(slot):
            write_tree_(stack_slice(self.state, slot - self.local_slots[0]),
                        one_state)

    def holds(self, slot: int) -> bool:
        """Whether this rank holds ``slot``'s state."""
        first, n = self.local_slots
        return first <= slot < first + n

    def insert(self, rid: int, one_state) -> Optional[int]:
        """Place a prefilled single-sequence state into a free slot."""
        slot = self.alloc(rid)
        if slot is not None:
            self.insert_at(slot, one_state)
        return slot

    def evict(self, slot: int):
        """Free a slot and blank its state (stale state never leaks into a
        later tenant even transiently)."""
        rid = self.owner.pop(slot)
        self.insert_at(slot, self._blank)
        self._free.append(slot)
        self._free.sort()
        return rid

    def read(self, slot: int):
        """A copy of one slot's single-sequence state (a slot this rank
        holds)."""
        assert self.holds(slot), (slot, self.local_slots)
        i = slot - self.local_slots[0]
        return tree_map(lambda p: p[i].clone(), self.state)

    def batched(self):
        """The pool (this rank's slots) as one decode state whose batch
        rows are the slots (the JAX engine's ``vmap`` over slots, written
        out): each
        ``[slots, n, 1, ...]`` leaf as ``[n, slots, ...]``, each ``pos`` /
        ``index`` leaf ``[slots, n, ...]`` as ``[n, slots, ...]``.  Views:
        a decode step's in-place writes land in the slots."""
        return _map_named(
            lambda name, x: x.transpose(0, 1) if name in _POSITION_LEAVES
            else x.select(2, 0).transpose(0, 1), self.state)

    # -- telemetry (parity with PagedKVCachePool) --------------------------

    def kv_bytes_held(self) -> int:
        """Slot-granular pools hold their full preallocation for the whole
        process lifetime — that constant is exactly what paging lifts.
        Counts state payload only (pos/index bookkeeping excluded) so the
        number is directly comparable to the paged pool's page bytes."""
        total = 0

        def add(name, leaf):
            nonlocal total
            if name not in _POSITION_LEAVES:
                total += leaf.numel() * leaf.element_size()
            return leaf

        _map_named(add, self.state)
        return total

    def kv_bytes_slotted(self) -> int:
        return self.kv_bytes_held()

    def clear_prefix_cache(self) -> None:
        """No prefix index to clear (the paged pool's hook, a no-op here so
        the Session can retire engines of either pool alike)."""
