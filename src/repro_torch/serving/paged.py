"""Page-granular KV-cache pool (vLLM-style) for continuous-batching decode.

(PyTorch port of the JAX package's pool.  The host bookkeeping is the
same; the pages are torch tensors on the engine's device written in place
— where the JAX pool donated its page buffers to a jitted ``_copy``, this
one does in-place index copies.  The engine admits through
``alloc_prefix`` and chunked prefill, since every paged family of the
port declares the prefix contract; the JAX pool's one-shot admission —
``can_admit``, ``alloc_for_insert``, ``insert_state`` and ``insert``, a
whole-prompt prefill cache scattered into private pages, contiguous
layouts only — is here too, for callers that prefill outside the pool.)

Where ``SlotKVCachePool`` preallocates a full decode cache per slot —
cache memory set by the worst case — this pool owns one *global* page pool
per layer for each cache leaf its ``KVLayout`` names (per-head ``k``/``v``
pages for GQA, latent ``ckv``/``krope`` pages for MLA), a free-page
allocator, and a per-slot page table.  Pages are allocated lazily as a
request's position crosses page boundaries and returned on eviction, so
the bytes *held* track the tokens actually cached, and ``num_pages`` can
provision less than the worst case (oversubscription; the engine preempts
on page pressure).

Page 0 is a reserved **trash page**: never allocated, it absorbs the
writes of slots without a request (their page tables are all-zero), of
insert padding, and of masked prefill-bucket tails, so the batched decode
and bucketed prefill keep their fixed shapes without masking any scatter.

**Layouts** (``repro_torch.serving.layouts.KVLayout``) own the physical page
geometry:

  * contiguous layouts ("kv", "latent") — token ``t`` of a slot lives at
    page ``table[slot, t // ps]``, offset ``t % ps``, forever;
  * ring layouts ("window", sliding-window/local attention) — the table is
    a ring of ``window // ps`` cells; token ``t`` lives at cell
    ``(t % window) // ps`` and a cell's page is *reused in place* as the
    sequence wraps, so a slot never holds more than ``window`` tokens —
    the paged twin of the slotted ring cache.  Reusing a cell whose page
    is shared (prefix-cache mapped) or indexed triggers copy-on-write (or
    a plain drop + fresh page when the whole block is being rewritten), so
    rotation can never corrupt another slot's — or the index's — K/V.

**Prefix caching** (``enable_prefix_cache``): every page holds a
*reference count* and, once its request's prefill commits, full
page-aligned prompt blocks are registered in a hash-trie index —
``chain_hash(block_0..i) -> page``.  A new request walks the index with
its own prompt blocks and maps every hit read-only (refcount++): those
positions are never re-prefilled and their pages never duplicated.  A
prompt *fully* covered by cached blocks reuses the last block's page
**copy-on-write** so the final token can re-run for its logits — unless
the pool has also memoized that prompt's greedy next token
(``cache_next_token``), in which case the last block maps read-only like
the rest and the admission dispatches nothing at all.  When a page's refcount drops to zero it parks in an
LRU of reusable cached pages and is reclaimed only when the allocator
runs dry; reclaiming (or rotating out) an indexed page leaves a
**phantom** entry — ``(None, parent_hash, tokens)`` — so the chain hash
still verifies through it and the *live tail* of a long windowed prompt
stays matchable: ring layouts map only the blocks still inside the new
request's window (``KVLayout.needed_start``) and count everything before
them as cached anyway (wholly window-masked, no page needed).

**Two-kind pools** (the ``hybrid`` layout: windowed and global layers
side by side) page the global layers as above, under the layout's leaves,
and give each slot a fixed ring of ``ring_window // ps`` cells in every
windowed layer, under ``ring_<leaf>``: cells ``1 + slot * width ..`` of
``1 + slots * width`` (cell 0 is the rings' trash page).  A ring never
changes owner or size, so admission binds it with the slot, and
preemption and retire release only the global pages; the ring-position
arithmetic masks what a slot's previous tenant left in its cells, as it
masks a reused page.  Decode operands and prefill chunks carry both
tables (``decode_operands``, ``chunk_tables``).

Device state is fixed-shape:
  * ``pages``   {leaf: [L, P, ps, ...]}  — written in place by decode,
    prefill chunks and copy-on-write
  * page table  [slots, table_width] int32 — host-owned (numpy); packed
    with ``pos`` and the per-slot step budgets into ONE int32 upload per
    decode cycle (``decode_operands`` — dispatch count, not bytes, is
    what a cycle pays for on the host side)
  * ``pos``     [slots] int32            — tokens cached per slot

Eviction hygiene: freed pages go back to the allocator without device-side
blanking — a page is only reachable through a table that points at it, the
next tenant's writes cover every position it reads (tails are masked by
length / ring-position arithmetic), so stale K/V can never influence
another request.  The aliasing property (no *private* page in two tables;
shared pages only ever read) is tested.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import NULL_TRACER
from repro_torch.serving.layouts import (KV_FULL, SCALE_SUFFIX, KVLayout,
                                        quantize_kv)


def paged_pspecs(pool_structs, *, model_size: int = 1,
                 layout: KVLayout = KV_FULL):
    """Placement tree for the page pool: each leaf's from the layout (KV
    heads -> "model" when divisible; pages replicate — any slot's pages
    live anywhere, so there is no data axis to shard them over).  The
    pool built under a ``models.common.model_axis`` holds exactly this
    rank's blocks."""
    return {name: layout.page_pspec(name, leaf, model_size)
            for name, leaf in pool_structs.items()}


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor without a host sync on CUDA: the copy
    goes through pinned memory with ``non_blocking``, so the pipelined
    engine's next plan overlaps the in-flight device step (a pageable copy
    would wait for the stream to drain)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def chain_blocks(tokens: Sequence[int], page_size: int, *,
                 start_block: int = 0, parent: Optional[int] = None):
    """Yield ``(block_idx, block_tokens, parent_hash, chain_hash)`` for each
    full ``page_size``-token block of ``tokens`` from ``start_block`` on.

    ``h_i = hash((h_{i-1}, block_i))``, seeded with ``page_size`` — a
    block's hash commits to the whole prefix, so two chains collide only
    when every leading block matches.  Deterministic within a process (int
    tuples; no PYTHONHASHSEED salt).  ``hash()`` is non-cryptographic, so
    the index additionally stores ``(parent_hash, block_tokens)`` per entry
    and every match is verified against them — a collision degrades to a
    cache miss, never to serving another prompt's K/V.  This generator is
    the ONLY place the chain step lives: lookup (``_plan``), registration
    (``commit_prefix``) and the test helper all walk through it, so the two
    sides of the index cannot drift."""
    h = page_size if parent is None else parent
    for i in range(start_block, len(tokens) // page_size):
        blk = tuple(tokens[i * page_size:(i + 1) * page_size])
        p, h = h, hash((h, blk))
        yield i, blk, p, h


def block_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """Chain hashes of the full blocks of ``tokens`` (see chain_blocks)."""
    return [h for _, _, _, h in chain_blocks(tokens, page_size)]


class PagedKVCachePool:
    """Global page pool + refcounted allocator + prefix index + page tables.

    ``blank_page_fn()`` must return ``ModelBundle.init_decode_state(1,
    page_size)``; through ``layout.page_template`` (int8 data leaves plus
    bf16 scale leaves for a quantized layout) its leaves (``"k"/"v"`` [L,
    1, ps, KV, hd]) are the one-page template the pool tiles ``num_pages``
    times on ``device``.  The engine's paged prefill writes pages in place
    after ``alloc_prefix``.
    """

    def __init__(self, num_slots: int, page_size: int, max_seq_len: int,
                 blank_page_fn, *, num_pages: int = 0,
                 enable_prefix_cache: bool = False,
                 layout: Optional[KVLayout] = None, tracer=None,
                 device="cpu"):
        assert num_slots >= 1 and page_size >= 1
        # cache events (alloc/COW/ring/LRU/prefix hit-miss) + plan spans go
        # to the engine's tracer; NULL_TRACER keeps every emit a no-op
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.layout = layout or KV_FULL
        self.layout.check_page_size(page_size)
        self.num_slots = num_slots
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.pages_per_slot = -(-max_seq_len // page_size)   # logical blocks
        self.padded_len = self.pages_per_slot * page_size
        self.table_width = self.layout.table_width(self.pages_per_slot,
                                                   page_size)
        worst = num_slots * self.table_width + 1             # +1 trash page
        self.num_pages = num_pages or worst
        if self.num_pages < self.table_width + 1:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold one request "
                f"(table_width={self.table_width} + trash page)")
        self.device = torch.device(device)
        self.enable_prefix_cache = enable_prefix_cache

        blank = blank_page_fn()
        missing = [k for k in self.layout.data_leaves if k not in blank]
        if missing:
            raise ValueError(
                f"paged pool ({self.layout.name} layout) needs decode-state "
                f"leaves {self.layout.data_leaves}; missing {missing} in "
                + str(sorted(blank)))
        P = self.num_pages
        # [L, 1, ps, ...] template -> [L, P, ps, ...] zeroed pages; int8
        # layouts swap each data leaf for int8 pages + a bf16 scale leaf
        # (the bundle's native state never carries scales — the pool owns
        # the storage format)
        one = self.layout.page_template(blank)
        n_ring = self.layout.ring_layers
        self.pages = {
            n: torch.zeros((t.shape[0] - n_ring, P) + tuple(t.shape[2:]),
                           dtype=t.dtype, device=self.device)
            for n, t in one.items()}
        # two-kind layouts: every slot's fixed ring in each windowed layer
        self.ring_width = (self.layout.ring_window // page_size
                           if n_ring else 0)
        self.ring_tables = 1 + np.arange(
            num_slots * self.ring_width, dtype=np.int32).reshape(
                num_slots, self.ring_width)
        if n_ring:
            cells = 1 + num_slots * self.ring_width
            self.pages.update({
                "ring_" + n: torch.zeros((n_ring, cells) + tuple(t.shape[2:]),
                                         dtype=t.dtype, device=self.device)
                for n, t in one.items()})

        # bytes of one page across layers and leaves (for telemetry)
        self.page_bytes = sum(
            self.pages[n].numel() * self.pages[n].element_size() // P
            for n in self.layout.leaves)
        # fp32-equivalent page bytes (data leaves at 4 B/elt, no scale
        # leaves) — the denominator of the int8 savings ratio
        self.page_bytes_fp32 = sum(
            self.pages[n].numel() * 4 // P for n in self.layout.data_leaves)

        # -- host bookkeeping ---------------------------------------------
        self._free_slots: List[int] = list(range(num_slots))
        self._free_pages: List[int] = list(range(1, P))      # 0 = trash
        self.refcount = np.zeros((P,), np.int32)             # per-page
        self.owner: Dict[int, int] = {}                      # slot -> rid
        self.held: Dict[int, List[int]] = {}                 # slot -> pages
        self._blocks: Dict[int, List[int]] = {}              # logical ids
        self._cells: Dict[int, Dict[int, int]] = {}          # cell -> block
        self.tables = np.zeros((num_slots, self.table_width), np.int32)
        self.pos = np.zeros((num_slots,), np.int32)
        # prefix index: chain hash -> (page | None, parent_hash, tokens) —
        # page None marks a *phantom* (reclaimed / rotated out): the chain
        # still verifies through it, it just has no K/V to map; the stored
        # pair verifies every hit (hash collisions degrade to misses);
        # reverse map page -> chain hash; per-slot commit cursor (next
        # block index, parent hash) so chunked commits hash each token
        # once; and the LRU of refcount-0 pages still indexed
        self._index: Dict[int, Tuple[Optional[int], int,
                                     Tuple[int, ...]]] = {}
        self._block_of_page: Dict[int, int] = {}
        self._commit_cursor: Dict[int, Tuple[int, int]] = {}
        self._cached_lru: "OrderedDict[int, None]" = OrderedDict()
        # plan memo keyed by prompt: steady-state traffic repeats prompts
        # (shared system prompts, resume re-prefills, probe-then-admit in
        # one cycle), so the chain-hash walk runs once per (prompt, index
        # epoch) instead of once per admission attempt.  Entries carry the
        # index version they were computed under and go stale — never
        # wrong — when the index changes; a bounded LRU caps host memory.
        self._index_version = 0
        self._plan_cache: "OrderedDict[Tuple[int, ...], Tuple[int, tuple]]" \
            = OrderedDict()
        self._plan_cache_cap = 512
        # greedy next-token memo: prompt -> the device scalar its prefill
        # argmaxed (see cache_next_token).  Content-addressed truth under
        # greedy decoding, so unlike the plan memo it needs no version —
        # only the LRU cap and clear_prefix_cache bound it.
        self._next_tok: "OrderedDict[Tuple[int, ...], object]" = OrderedDict()
        self.tracer.instant("pool.init", num_pages=self.num_pages,
                            page_size=page_size,
                            table_width=self.table_width,
                            **self.layout.describe())
        self.pages_allocated = 0                             # lifetime counters
        self.pages_freed = 0
        self.peak_pages_held = 0
        self.prefix_hit_pages = 0                            # shared mappings
        self.cow_copies = 0
        self.ring_rotations = 0                              # ring cells reused
        self.cached_pages_evicted = 0                        # LRU reclaims

    # -- device page copies (in place) -------------------------------------

    def _copy(self, dst: int, src: int) -> None:
        """Copy-on-write: duplicate page ``src`` into ``dst`` (every layer,
        every leaf) so the new tenant can overwrite its tail."""
        for n in self.layout.leaves:
            self.pages[n][:, dst].copy_(self.pages[n][:, src])

    # -- host bookkeeping --------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self.owner)

    @property
    def pages_held(self) -> int:
        """Pages referenced by at least one live slot (shared pages count
        once — that is the point of sharing them)."""
        return int((self.refcount > 0).sum())

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages parked in the prefix-cache LRU (reclaimable)."""
        return len(self._cached_lru)

    def _page_budget(self) -> int:
        """Pages the allocator can hand out right now: content-free pages
        plus reclaimable cached ones."""
        return len(self._free_pages) + len(self._cached_lru)

    def can_admit(self, n_tokens: int) -> bool:
        """Is there a slot and enough free pages for an n_tokens prefill
        (ignoring any prefix sharing — see ``can_admit_prompt``)?  Ring
        layouts cap the need at the table width: later blocks reuse cells
        in place."""
        need = min(-(-n_tokens // self.page_size), self.table_width)
        return bool(self._free_slots) and self._page_budget() >= need

    def can_admit_prompt(self, prompt: Sequence[int]) -> bool:
        """Is there a slot and enough pages for ``prompt``, net of the
        pages a prefix-cache hit would share?"""
        if not self._free_slots:
            return False
        shared, cow_src, _, _, start_blk = self._plan(prompt)
        total = -(-len(prompt) // self.page_size)
        upfront = min(total, start_blk + self.table_width) - start_blk
        return self._alloc_budget(shared, cow_src) >= upfront - len(shared)

    def _alloc_budget(self, shared: List[int], cow_src: Optional[int]) -> int:
        """Allocatable pages for one admission: the global budget minus LRU
        pages this very admission will map/pin (they stop being
        reclaimable the moment they are re-referenced)."""
        pinned = sum(1 for p in shared + ([cow_src] if cow_src is not None
                                          else []) if p in self._cached_lru)
        return self._page_budget() - pinned

    # -- page plumbing -----------------------------------------------------

    def _take_slot(self, rid: int) -> int:
        """Pop a free slot and zero its bookkeeping (table row -> trash)."""
        slot = self._free_slots.pop(0)
        assert slot not in self.owner, f"slot {slot} double-assigned"
        self.owner[slot] = rid
        self.held[slot] = []
        self._blocks[slot] = []
        self._cells[slot] = {}
        self.tables[slot] = 0
        return slot

    def _grab(self) -> Optional[int]:
        """Acquire a raw page: content-free pages first, then reclaim the
        least-recently-used cached page.  Reclaiming leaves a *phantom*
        index entry so the chain hash still verifies through the block."""
        if self._free_pages:
            return self._free_pages.pop(0)
        if self._cached_lru:
            pid, _ = self._cached_lru.popitem(last=False)
            h = self._block_of_page.pop(pid)
            entry = self._index.get(h)
            if entry is not None and entry[0] == pid:
                self._index[h] = (None, entry[1], entry[2])
                self._prune_phantoms()
            self._index_version += 1
            self.cached_pages_evicted += 1
            self.tracer.instant("pool.lru_reclaim", page=pid)
            return pid
        return None

    def _prune_phantoms(self) -> None:
        """Bound the index: phantoms keep chains matchable past reclaimed
        pages, but a steady stream of distinct prompts would otherwise
        grow ``_index`` without limit (pre-phantom behaviour deleted on
        reclaim, capping it at ~num_pages entries).  When phantoms
        outnumber live entries several-fold, drop them all in one sweep —
        chains through them degrade to misses, exactly the old semantics,
        amortized O(1) per reclaim."""
        live = len(self._block_of_page)
        if len(self._index) - live > max(4 * self.num_pages, 4 * live):
            self._index = {h: e for h, e in self._index.items()
                           if e[0] is not None}
            self._index_version += 1

    def _bind(self, slot: int, block: int, pid: int) -> None:
        """Hand a fresh private page to ``slot`` as logical ``block``."""
        self.refcount[pid] = 1
        self.held[slot].append(pid)
        self._blocks[slot].append(block)
        cell = self.layout.cell(block, self.table_width)
        self._cells[slot][cell] = block
        self.tables[slot, cell] = pid
        self.pages_allocated += 1
        self.tracer.instant("pool.page_alloc", page=pid, slot=slot,
                            block=block)

    def _alloc_page(self, slot: int, block: int) -> Optional[int]:
        pid = self._grab()
        if pid is not None:
            self._bind(slot, block, pid)
        return pid

    def _retain_page(self, pid: int) -> None:
        """refcount++; a 0 -> 1 transition pulls the page out of the LRU and
        counts as an allocation, keeping ``pages_allocated == pages_freed``
        a drain invariant even when cached pages cycle through reuse."""
        if self.refcount[pid] == 0:
            self._cached_lru.pop(pid, None)
            self.pages_allocated += 1
        self.refcount[pid] += 1

    def _map_shared(self, slot: int, pid: int, block: int) -> None:
        """Map an indexed page read-only into ``slot`` as ``block``."""
        self._retain_page(pid)
        self.held[slot].append(pid)
        self._blocks[slot].append(block)
        cell = self.layout.cell(block, self.table_width)
        self._cells[slot][cell] = block
        self.tables[slot, cell] = pid
        self.prefix_hit_pages += 1

    def _release_page(self, pid: int) -> None:
        """Drop one reference; at zero the page parks in the LRU when its
        content is indexed (reusable prefix) and frees otherwise."""
        self.refcount[pid] -= 1
        assert self.refcount[pid] >= 0, f"page {pid} refcount underflow"
        if self.refcount[pid] == 0:
            self.pages_freed += 1
            if pid in self._block_of_page:
                self._cached_lru[pid] = None        # most-recent end
                self.tracer.instant("pool.lru_park", page=pid)
            else:
                self._free_pages.append(pid)
                self._free_pages.sort()
                self.tracer.instant("pool.page_free", page=pid)

    def _page_at(self, slot: int, block: int) -> int:
        return self.held[slot][self._blocks[slot].index(block)]

    def _unbind(self, slot: int, block: int) -> None:
        """Drop ``block`` from the slot (ring rotation / full rewrite)."""
        i = self._blocks[slot].index(block)
        pid = self.held[slot].pop(i)
        self._blocks[slot].pop(i)
        cell = self.layout.cell(block, self.table_width)
        if self._cells[slot].get(cell) == block:
            del self._cells[slot][cell]
        if self.tables[slot, cell] == pid:
            self.tables[slot, cell] = 0
        self._release_page(pid)

    def _cow(self, slot: int, block: int, src: int) -> Optional[int]:
        """Copy-on-write ``src`` (shared or indexed) into a fresh private
        page bound as ``block``, releasing the slot's reference to src."""
        dst = self._grab()
        if dst is None:
            return None
        self._copy(dst, src)
        self.cow_copies += 1
        self.tracer.instant("pool.cow", src=src, dst=dst, slot=slot,
                            block=block)
        # src is mapped at most once per slot: replace it in place
        i = self.held[slot].index(src)
        self.held[slot][i] = dst
        self._blocks[slot][i] = block
        cell = self.layout.cell(block, self.table_width)
        self._cells[slot][cell] = block
        self.tables[slot, cell] = dst
        self.refcount[dst] = 1
        self.pages_allocated += 1
        self._release_page(src)
        return dst

    def _ensure_writable(self, slot: int, lo: int, hi: int) -> bool:
        """Make every page that positions ``lo..hi`` will write privately
        writable: allocate missing blocks, rotate ring cells whose
        incumbent block has wrapped out of the window (reusing a private
        page in place; copy-on-writing a shared or indexed one), and COW a
        same-block page another slot or the index can still read.  Returns
        False on page starvation (caller preempts)."""
        ps = self.page_size
        for b in range(lo // ps, hi // ps + 1):
            cell = self.layout.cell(b, self.table_width)
            cur = self._cells[slot].get(cell)
            if cur == b:
                pid = self._page_at(slot, b)
                if self.refcount[pid] > 1 or pid in self._block_of_page:
                    if self._cow(slot, b, pid) is None:
                        return False
            elif cur is None:
                if self._alloc_page(slot, b) is None:
                    return False
            else:                       # ring rotation: cur wrapped out
                pid = self._page_at(slot, cur)
                if self.refcount[pid] == 1 and \
                        pid not in self._block_of_page:
                    # private, unindexed: reuse the page in place — the
                    # ring-position arithmetic resolves its mixed old/new
                    # offsets, so no copy and no allocator traffic
                    i = self._blocks[slot].index(cur)
                    self._blocks[slot][i] = b
                    self._cells[slot][cell] = b
                    self.ring_rotations += 1
                    self.tracer.instant("pool.ring_rotate", slot=slot,
                                        page=pid, old_block=cur, block=b)
                else:
                    # shared / indexed incumbent: COW into a private page
                    # and release the original (it parks in the LRU when
                    # indexed).  The copy is never skipped, even when the
                    # new block rewrites every offset: a prefill chunk's
                    # early queries still attend the old positions through
                    # the pre-write snapshot, which reads whatever page
                    # the table holds when the chunk runs.
                    dst = self._grab()
                    if dst is None:
                        return False
                    self._copy(dst, pid)
                    self.cow_copies += 1
                    self.ring_rotations += 1
                    self.tracer.instant("pool.ring_rotate", slot=slot,
                                        page=pid, old_block=cur, block=b,
                                        cow_dst=dst)
                    self._unbind(slot, cur)
                    self._bind(slot, b, dst)
        return True

    # -- prefix matching ---------------------------------------------------

    def _plan(self, prompt: Sequence[int]
              ) -> Tuple[List[int], Optional[int], int, Tuple[int, int], int]:
        """(shared_pages, cow_src_page, cached_tokens, commit_seed,
        shared_start_block) for ``prompt``; commit_seed = (first block to
        register, its parent chain hash) — ``alloc_prefix`` seeds the
        slot's commit cursor with it, so ``commit_prefix`` never re-hashes
        blocks the match already walked.

        Walks the chain-hash index over the prompt's full blocks, verifying
        each hit's stored (parent_hash, block_tokens) so a ``hash()``
        collision can only miss, never alias another prompt's pages.  The
        walk passes *through* phantom entries (page reclaimed or rotated
        out) — the chain still verifies — and then shrinks the match until
        every block the suffix will actually read
        (``layout.needed_start``..match) has a live page; for ring layouts
        blocks before ``needed_start`` are wholly window-masked, so they
        count as cached without needing any page at all.  A match covering
        the *entire* prompt keeps its last block out of the read-only
        mapping and returns it as ``cow_src`` instead: the final prompt
        token must still run (logits), so that page is duplicated
        copy-on-write and cached_tokens caps at len(prompt) - 1.  Results
        are memoized per prompt (bounded LRU) until the index next
        changes, so a probe (``can_admit_prompt``) followed by the
        admission — and every repeat of a steady-state prompt between
        index changes — re-plans nothing.
        """
        ps = self.page_size
        plen = len(prompt)
        if not self.enable_prefix_cache:
            return [], None, 0, (0, ps), 0
        key = tuple(prompt)
        memo = self._plan_cache.get(key)
        if memo is not None:
            if memo[0] == self._index_version:
                self._plan_cache.move_to_end(key)
                return memo[1]
            del self._plan_cache[key]           # stale: index moved on
        with self.tracer.span("plan", tokens=plen):
            pids: List[Optional[int]] = []
            hashes: List[int] = []
            for _, blk, parent, h in chain_blocks(prompt, ps):
                entry = self._index.get(h)
                if entry is None or entry[1] != parent or entry[2] != blk:
                    break
                pids.append(entry[0])
                hashes.append(h)
            m = len(pids)
            total_full = plen // ps
            while m:
                full = (m == total_full and m * ps == plen)
                cached = plen - 1 if full else m * ps
                start_blk = self.layout.needed_start(cached, ps)
                dead = [i for i in range(start_blk, m) if pids[i] is None]
                if not dead:
                    break
                m = min(dead)       # truncate below the oldest dead block
            if not m:
                out = [], None, 0, (0, ps), 0
            elif m == total_full and m * ps == plen:
                # the shared read-only blocks end one short of the match;
                # the COW block itself is already indexed, so commits
                # resume there
                seed = (m - 1, hashes[m - 2] if m > 1 else ps)
                out = pids[start_blk:m - 1], pids[m - 1], plen - 1, seed, \
                    start_blk
            else:
                out = pids[start_blk:m], None, m * ps, (m, hashes[m - 1]), \
                    start_blk
            self._plan_cache[key] = (self._index_version, out)
            if len(self._plan_cache) > self._plan_cache_cap:
                self._plan_cache.popitem(last=False)
        return out

    # -- engine API --------------------------------------------------------

    def alloc_prefix(self, rid: int, prompt: Sequence[int], *,
                     use_memo: bool = True) -> Optional[Tuple[int, int]]:
        """Allocate a slot for ``prompt``, mapping the longest cached
        page-aligned prefix read-only and private pages for the rest.

        Returns (slot, cached_tokens) — the engine prefills only positions
        ``cached_tokens..len(prompt)-1`` — or None when slots or pages run
        short (caller re-queues the request).  ``pos`` is set to the full
        prompt length up front; the engine masks the slot out of decode
        until its chunked prefill completes.  Ring layouts allocate at most
        one table-width of pages up front: later blocks reuse cells in
        place (``prepare_chunk`` rotates them ahead of each write).

        ``use_memo=False`` skips the greedy next-token memo promotion:
        sampled requests must re-run the last prompt token for its
        logits (the memo is the *greedy* continuation), so their full
        hits stay at ``len(prompt) - 1`` cached tokens with a COW last
        page.
        """
        plen = len(prompt)
        shared, cow_src, cached, seed, start_blk = self._plan(prompt)
        if use_memo and cow_src is not None and cached == plen - 1 and \
                self.cached_next_token(prompt) is not None:
            # full hit with a remembered next token: the last block joins
            # the read-only mapping like every other — nothing re-runs, so
            # nothing writes into a shared page and the COW the last-token
            # replay would have forced disappears (see cache_next_token).
            # cached == len(prompt) tells the engine to skip prefill
            # entirely and seed decode from the memoized token.
            shared = shared + [cow_src]
            cow_src = None
            cached = plen
        total = -(-plen // self.page_size)
        upfront_end = min(total, start_blk + self.table_width)
        need = (upfront_end - start_blk) - len(shared)
        if not self._free_slots or \
                self._alloc_budget(shared, cow_src) < need:
            return None
        if cached:
            self.tracer.instant("pool.prefix_hit", rid=rid,
                                cached_tokens=cached,
                                shared_pages=len(shared),
                                cow=cow_src is not None)
        elif self.enable_prefix_cache:
            self.tracer.instant("pool.prefix_miss", rid=rid,
                                prompt_tokens=plen)
        slot = self._take_slot(rid)
        # the commit cursor resumes after the matched prefix — blocks the
        # plan walked are never re-hashed by commit_prefix
        self._commit_cursor[slot] = seed
        blk = start_blk
        for pid in shared:
            self._map_shared(slot, pid, blk)
            blk += 1
        if cow_src is not None:
            # pin the source so this alloc's own page grabs cannot reclaim
            # it out of the LRU before the device copy lands
            self._retain_page(cow_src)
            dst = self._alloc_page(slot, blk)
            self._copy(dst, cow_src)
            self.cow_copies += 1
            self._release_page(cow_src)
            blk += 1
        while blk < upfront_end:
            self._alloc_page(slot, blk)
            blk += 1
        self.pos[slot] = plen
        self.peak_pages_held = max(self.peak_pages_held, self.pages_held)
        return slot, cached

    def prepare_chunk(self, slot: int, start: int, end: int) -> bool:
        """Make the pages positions ``start..end`` (one prefill chunk) will
        write privately writable — ring rotation, COW of shared or indexed
        incumbents.  Contiguous layouts preallocated at admission, so this
        sweep is a cheap no-op there.  False on page starvation (the
        caller preempts to relieve the pressure)."""
        ok = self._ensure_writable(slot, start, end)
        self.peak_pages_held = max(self.peak_pages_held, self.pages_held)
        return ok

    def commit_prefix(self, slot: int, prompt: Sequence[int]) -> None:
        """Register the slot's now-written full prompt blocks in the index
        (first writer wins; later identical blocks stay private and simply
        free on eviction — except that a live page *resurrects* a phantom
        entry for its block).  Chunked prefill calls this after every chunk
        with a growing prefix; the per-slot cursor resumes the chain hash
        where the last call stopped, so each token is hashed exactly once
        per admission.  Ring layouts register a block's page only while the
        slot still holds it — a block that has already rotated out of the
        window leaves a phantom entry, keeping the chain (and the live
        tail) matchable."""
        if not self.enable_prefix_cache:
            return
        ps = self.page_size
        start, parent = self._commit_cursor.get(slot, (0, ps))
        cursor = (start, parent)
        for i, blk, p, h in chain_blocks(prompt, ps, start_block=start,
                                         parent=parent):
            pid = (self._page_at(slot, i) if i in self._blocks[slot]
                   else None)
            entry = self._index.get(h)
            if entry is None or (entry[0] is None and pid is not None):
                self._index[h] = (pid, p, blk)
                if pid is not None:
                    self._block_of_page[pid] = h
                self._index_version += 1
            cursor = (i + 1, h)
        self._commit_cursor[slot] = cursor

    # -- one-shot admission (contiguous layouts) ----------------------------

    def alloc_for_insert(self, rid: int, n_tokens: int) -> Optional[int]:
        """Host half of the non-sharing admission: take a slot and allocate
        ceil(n_tokens / page_size) private pages for it, before any prefill
        has run.  None when slots or pages are exhausted (the caller
        re-queues the request).  Contiguous layouts only — a ring cache
        has no padded contiguous image (the prefix path, ``alloc_prefix``
        + paged prefill, serves ring layouts)."""
        if self.layout.ring or self.ring_width:
            raise ValueError(
                "ring (windowed) layouts prefill straight into pages via "
                "alloc_prefix + PagedPrefillContract; the contiguous "
                "insert path cannot represent a ring cache")
        if not self.can_admit(n_tokens):
            return None
        slot = self._take_slot(rid)
        for b in range(-(-n_tokens // self.page_size)):
            self._alloc_page(slot, b)
        self.pos[slot] = n_tokens
        self.peak_pages_held = max(self.peak_pages_held, self.pages_held)
        return slot

    def insert_state(self, slot: int, one_state) -> None:
        """Device half: scatter a prefilled cache (its data leaves [L, 1,
        padded_len, ...]: ``cache_len == padded_len``) into the pages
        ``alloc_for_insert`` bound to ``slot``, in place.  Table entries
        past the prompt's pages point at the trash page and receive the
        blank tail chunks.  Quantized layouts quantize here with the same
        ``quantize_kv`` the incremental write paths use."""
        ids = torch.as_tensor(self.tables[slot], dtype=torch.long,
                              device=self.device)
        for n in self.layout.data_leaves:
            x = one_state[n]
            xr = x[:, 0].reshape((x.shape[0], self.pages_per_slot,
                                  self.page_size) + tuple(x.shape[3:]))
            xr = xr.to(self.device)
            if self.layout.quantized:
                q, sc = quantize_kv(xr)
                self.pages[n][:, ids] = q
                self.pages[n + SCALE_SUFFIX][:, ids] = sc
            else:
                self.pages[n][:, ids] = xr.to(self.pages[n].dtype)

    def insert(self, rid: int, one_state, n_tokens: int) -> Optional[int]:
        """One-shot admission: ``alloc_for_insert`` + ``insert_state``."""
        slot = self.alloc_for_insert(rid, n_tokens)
        if slot is not None:
            self.insert_state(slot, one_state)
        return slot

    def evict(self, slot: int) -> int:
        """Free a slot: every mapped page drops one reference; pages whose
        content is indexed park in the prefix LRU instead of freeing (no
        device blanking either way — see module docstring on hygiene)."""
        rid = self.owner.pop(slot)
        for pid in self.held.pop(slot):
            self._release_page(pid)
        self._blocks.pop(slot, None)
        self._cells.pop(slot, None)
        self._commit_cursor.pop(slot, None)
        self.tables[slot] = 0
        self.pos[slot] = 0
        self._free_slots.append(slot)
        self._free_slots.sort()
        return rid

    def clear_prefix_cache(self) -> None:
        """Invalidate the prefix index: every refcount-0 cached page returns
        to the free list and no future request can map a previously cached
        block.  Live slots keep serving off their mapped pages — but those
        pages are de-indexed too, so they free (rather than park) on
        eviction.  Call when cached K/V stops being valid (weight updates,
        layout switches) or to measure cold-start behaviour on a warm
        engine."""
        self.tracer.instant("pool.prefix_clear",
                            cached_pages=len(self._cached_lru),
                            index_entries=len(self._index))
        self._free_pages.extend(self._cached_lru)
        self._free_pages.sort()
        self._cached_lru.clear()
        self._index.clear()
        self._block_of_page.clear()
        # the version bump alone invalidates memoized plans lazily; drop
        # them eagerly too so a cleared cache frees the host memory as well
        self._index_version += 1
        self._plan_cache.clear()
        self._next_tok.clear()

    def cache_next_token(self, prompt: Sequence[int], tok) -> None:
        """Remember the greedy token that follows ``prompt`` — the device
        scalar its prefill argmaxed, stored WITHOUT syncing.  Greedy
        decoding is deterministic, so (prompt -> next token) is
        content-addressed truth: a later admission whose prompt is fully
        covered by cached blocks skips its last-token replay — and the COW
        of the shared page that replay would have written into — and seeds
        decode straight from the memo (``alloc_prefix`` reports
        ``cached == len(prompt)``).  That turns a steady-state repeat
        admission from two device dispatches (copy + bucketed 1-token
        prefill) into zero."""
        if not self.enable_prefix_cache:
            return
        key = tuple(int(t) for t in prompt)
        self._next_tok[key] = tok
        self._next_tok.move_to_end(key)
        if len(self._next_tok) > self._plan_cache_cap:
            self._next_tok.popitem(last=False)

    def cached_next_token(self, prompt: Sequence[int]):
        """The memoized greedy next token for ``prompt`` (device scalar),
        or None."""
        return self._next_tok.get(tuple(int(t) for t in prompt))

    def ensure_decode_capacity(self, skip=(), steps=None) -> List[int]:
        """Make every active slot able to write its next decode span:
        positions ``pos .. pos + steps[slot] - 1`` (``steps`` maps slot ->
        span length; absent or None means 1 — the single-step legacy
        shape).  Lazily allocates the pages a contiguous slot's next blocks
        need; rotates / COWs the ring cells a windowed slot wraps into —
        the multi-block sweep is the same ``_ensure_writable`` walk chunked
        prefill uses, so a ``decode_steps``-long on-device scan can write
        its whole span into prepared private pages.  Returns the slots
        that could not be extended — the engine preempts to relieve the
        pressure.  Slots in ``skip`` (still prefilling, or masked out of
        this cycle's scan) are left alone."""
        starved = []
        for slot in self.active_slots:
            if slot in skip:
                continue
            n = 1 if steps is None else int(steps.get(slot, 1))
            if n <= 0:
                continue
            pos = int(self.pos[slot])
            if not self._ensure_writable(slot, pos, pos + n - 1):
                starved.append(slot)
        self.peak_pages_held = max(self.peak_pages_held, self.pages_held)
        return starved

    def safe_decode_span(self, slot: int, n: int) -> int:
        """Longest prefix of the decode span ``pos..pos+n-1`` whose writes
        need no ring rotation: every block is already bound to the slot or
        lands in a free cell.  The pipelined engine caps a chunk-completing
        slot's same-cycle decode span with this — its chunk's blocks are
        committed to the prefix index only at submit, so a rotation planned
        before that would see an unindexed incumbent and rename its page in
        place, losing the just-prefilled block from the index (content
        stays correct).  Speculative verify spans are capped the same way
        (verify writes like a chunk, without rotation).  Contiguous
        layouts never rotate: ``n``."""
        if not self.layout.ring:
            return n
        ps = self.page_size
        pos = int(self.pos[slot])
        for k in range(n):
            b = (pos + k) // ps
            cur = self._cells[slot].get(self.layout.cell(b, self.table_width))
            if cur is not None and cur != b:
                return k
        return n

    def decode_operands(self, limits: Dict[int, int],
                        mask_slots=()) -> torch.Tensor:
        """One packed ``[slots, table_width (+ ring_width) + 2]`` int32
        device operand for a decode dispatch: the page table (and a
        two-kind pool's ring table), per-slot position and per-slot step
        budget travel as a single upload and are sliced apart inside the
        decode loop (``unpack_operands``).  Packing matters
        because at serving batch sizes the per-cycle cost is *dispatch
        count*, not bytes: one ``device_put`` here replaces the three
        (table, pos, limits) the unpacked path paid every cycle.  Slots in
        ``mask_slots`` (mid-prefill or not scheduled this cycle) present an
        all-trash table, pos 0 and budget 0, so the fixed-shape decode can
        run while they fill."""
        W = self.table_width
        packed = np.empty((self.num_slots, W + self.ring_width + 2),
                          np.int32)
        packed[:, :W] = self.tables
        packed[:, W:-2] = self.ring_tables
        packed[:, -2] = self.pos
        packed[:, -1] = [limits.get(s, 0) for s in range(self.num_slots)]
        if mask_slots:
            packed[list(mask_slots)] = 0
        return upload(packed, self.device)

    def unpack_operands(self, packed):
        """``decode_operands``' columns apart again, on the device (views):
        ({"page_table"[, "ring_table"]}, pos, limits)."""
        W = self.table_width
        tables = {"page_table": packed[:, :W].contiguous()}
        if self.ring_width:
            tables["ring_table"] = packed[:, W:-2].contiguous()
        return tables, packed[:, -2], packed[:, -1]

    def chunk_tables(self, slot: int) -> Dict[str, torch.Tensor]:
        """A prefill chunk's tables on the device: the slot's page-table row
        and, in a two-kind pool, its ring row."""
        out = {"page_table": upload(self.tables[slot], self.device)}
        if self.ring_width:
            out["ring_table"] = upload(self.ring_tables[slot], self.device)
        return out

    def rewind(self, slot: int, new_pos: int) -> None:
        """Roll a slot's position back after a rejected speculative suffix.

        The speculative verify advanced ``pos`` optimistically past its
        drafted span; positions ``new_pos..`` now hold unverified K/V
        that nothing will ever read (decode attends ``0..pos`` and the
        next writes cover them — the same hygiene argument as page
        reuse, see module docstring), so only host bookkeeping moves:
        ``pos`` drops to ``new_pos`` and — contiguous layouts — blocks
        wholly past the new position unbind, freeing their pages.  Ring
        layouts keep their cells bound: the verify span was planned
        rotation-free (``safe_decode_span``), so every touched block is
        already the cell's incumbent and is rewritten in place as the
        sequence grows again."""
        assert new_pos >= 1, new_pos
        if not self.layout.ring:
            last_blk = (new_pos - 1) // self.page_size
            for b in [b for b in self._blocks[slot] if b > last_blk]:
                self._unbind(slot, b)
        self.pos[slot] = new_pos

    def advance(self, skip=(), steps=None) -> None:
        """A decode dispatch happened: every decoding slot cached
        ``steps[slot]`` tokens (1 when ``steps`` is None — the legacy
        single-step shape).  The pipelined engine calls this at submit
        time: the host position is deterministic once the span is planned,
        so the next cycle's plan can run against it while the device step
        is still in flight."""
        for slot in self.owner:
            if slot not in skip:
                self.pos[slot] += (1 if steps is None
                                   else int(steps.get(slot, 0)))

    # -- telemetry ---------------------------------------------------------

    def kv_bytes_held(self) -> int:
        return self.pages_held * self.page_bytes

    def kv_bytes_capacity(self) -> int:
        return (self.num_pages - 1) * self.page_bytes

    def kv_bytes_slotted(self) -> int:
        """K/V bytes a slot-granular pool would statically preallocate for
        the same config — ``max_seq_len`` tokens per slot, bounded by the
        window for ring layouts (the slotted ring cache is window-sized
        too), no page padding."""
        return self.num_slots * self.layout.live_tokens(self.max_seq_len) \
            * (self.page_bytes // self.page_size)
