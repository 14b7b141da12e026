"""KVCacheManager — the serving tier's cache layer, on torch tensors.

Counterpart of the reference package's ``serving/cache_manager.py``, in
its two modes.  ``cache_mode="dense"`` (the default, as in the
reference) reserves ``model.init_cache(max_batch, max_len)`` whole: a KV
row or an SSM state row per slot, zeroed at admission, with no pages and
no prefix cache.  ``cache_mode="paged"`` keeps the reference's host-side
logic unchanged: the
free-list allocator with per-page refcounts, allocate-on-write, copy-on-
write of shared pages, adaptive pool sizing, the radix prefix cache
with sub-page (token-granularity) stitching, and pool-pressure recovery
by LRU prefix eviction then youngest-slot preemption.  Every site that
touches the device is rewritten in torch: pool creation and growth,
the page copy, the page-table push, and the optional cross-host prefix
store's page pulls and hydration writes
(:mod:`repro_torch.serving.prefix_store`).  Both caches are updated in
place.

Contracts with the other layers:

- the executor passes :attr:`cache` to its dispatches; :meth:`push_table`
  must be called before any dispatch so the device page table matches
  the host shadow (the sentinel moves when the pool grows);
- :meth:`ensure_pages` is called ahead of every dispatch that will write
  a row's positions; ``False`` means the row was requeued and must be
  dropped from the dispatch.  A speculative verify dispatch calls
  :meth:`reserve_speculative` instead (its draft positions are backed
  best-effort) and :meth:`rewind_slot` after it, to drop the pages past
  the accepted frontier;
- at admission the scheduler calls :meth:`stitch_prefix`; when a prompt
  becomes fully resident the executor calls :meth:`prefix_insert`.  With
  a store attached the first hydrates pages other workers published and
  the second publishes the prompt's full pages;
- store traffic stays on the engine's thread except the npz pack and
  the write, which :class:`~repro_torch.serving.prefix_store.AsyncPublisher`
  runs in the background on host copies pulled at submit time;
  :meth:`flush_store` is the drain seam.

Allocator invariants (checked by :meth:`check_invariants`): a page's
refcount equals the number of slot tables mapping it plus one if the
radix cache indexes it; a page returns to the free list exactly at
refcount zero; after a full drain ``pages_in_use`` equals the pages the
radix cache retains, each at refcount 1.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.prefix_store import PrefixStore, device_page, host_dtype, host_page
from repro_torch.serving.types import EngineStats, Slot
from repro_torch.tree import tree_leaves

_LOG = logging.getLogger(__name__)


class KVCacheManager:
    def __init__(
        self,
        model,
        *,
        max_batch: int,
        max_len: int,
        stats: EngineStats,
        device: torch.device,
        cache_mode: str = "dense",
        page_size: int = 16,
        total_pages: Optional[int] = None,
        prefix_cache: bool = True,
        prefix_match: str = "token",
        prefix_store: Optional[PrefixStore] = None,
    ):
        if prefix_match not in ("token", "page"):
            raise ValueError(
                f"prefix_match must be token|page, got {prefix_match!r}"
            )
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.stats = stats
        self.device = device
        self.cache_mode = cache_mode
        self.page_size = int(page_size)
        # "token" (default) additionally reuses the longest common token
        # prefix inside the first divergent page via a CoW copy of the
        # partially-matched page; "page" restores page-aligned matching
        self.prefix_match = prefix_match
        self.store = prefix_store if cache_mode == "paged" else None
        # background publish worker (created on first use): the tick loop
        # pulls page bytes and counts synchronously, the object-store write
        # happens off-thread; flush_store() is the drain seam
        self._publisher = None
        # chunk keys this engine has already published or seen present:
        # later requests sharing the prefix skip a store round-trip a chunk
        self._published: set = set()
        # wired by the engine to RequestScheduler.preempt_for /
        # RequestScheduler.preempt: pool-pressure recovery crosses the
        # layer seam exactly here.  preempt_for never victimizes the
        # requester; when it answers YIELD the requester is requeued via
        # preempt_row — at a clean seam AFTER the allocation loop unwinds
        self.preempt_for: Callable[[int], Optional[int]] = lambda row: None
        self.preempt_row: Callable[[int], None] = lambda row: None
        if cache_mode != "paged":
            self.prefix = None
            self._adaptive = False
            self.cache = model.init_cache(max_batch, max_len, device=device)
            return
        self.pages_per_slot = -(-max_len // self.page_size)
        self.prefix = PrefixCache(self.page_size) if prefix_cache else None
        self._adaptive = not total_pages
        if total_pages:
            self._init_paged_pool(int(total_pages), queue_depth=0)
        else:
            # sized adaptively from queue depth at first submit (and grown,
            # up to the dense reservation, on later submits)
            self.n_pages: Optional[int] = None
            self.cache = None

    def cache_is_rolling(self) -> bool:
        """Whether the dense KV cache rolls: a sliding-window cache holds
        fewer slots than ``max_len`` and wraps its writes mod its length,
        so a right-padded prefill chunk could alias still-visible slots;
        prompts then ingest through the decode path.  A paged cache never
        rolls (an adaptively sized pool may not exist yet)."""
        k = self.cache.get("k") if isinstance(self.cache, dict) else None
        return k is not None and k.shape[2] < self.max_len

    # ------------------------------------------------------------ pool setup
    def _init_paged_pool(self, total_pages: Optional[int], queue_depth: int,
                         pending: Optional[list] = None) -> None:
        """Create the device page pool and the host-side allocator state
        (``total_pages=None``: sized from the queue, see
        :meth:`_adaptive_pages`)."""
        dense_pages = self.max_batch * self.pages_per_slot
        if total_pages is None:
            total_pages = self._adaptive_pages(pending or [])
            _LOG.info(
                "paged pool sized adaptively: %d pages of %d tokens "
                "(queue depth %d, max_batch %d, dense reservation %d pages)",
                total_pages, self.page_size, queue_depth, self.max_batch,
                dense_pages,
            )
        self.n_pages = int(total_pages)
        self.cache = self.model.init_cache(
            self.max_batch, self.max_len,
            paged=True, page_size=self.page_size, n_pages=self.n_pages,
            device=self.device,
        )
        # host-side allocator: free list + per-page refcounts + per-slot
        # page lists + the numpy shadow of the device page table (sentinel
        # n_pages = unbacked)
        self._free_pages = list(range(self.n_pages))
        self._page_refs = [0] * self.n_pages
        self._slot_pages: List[List[int]] = [[] for _ in range(self.max_batch)]
        self._table = np.full(
            (self.max_batch, self.pages_per_slot), self.n_pages, np.int32
        )
        self._table_dirty = True
        # bytes of ONE page across every layer and pool leaf (k + v)
        self.stats.page_bytes = sum(
            leaf.numel() * leaf.element_size() // self.n_pages
            for leaf in self._pool_leaves().values()
        )
        self.stats.dense_cache_bytes = dense_pages * self.stats.page_bytes

    def _pool_leaves(self) -> Dict[str, torch.Tensor]:
        return {name: leaf for name, leaf in self.cache.items() if name.endswith("_pages")}

    def _adaptive_pages(self, pending: list) -> int:
        """Pool size for the current queue: pages for the
        ``min(max_batch, queue depth)`` largest queued requests (prompt +
        new-token budget, whole pages) + one request of headroom for
        retained prefixes + pages already resident, clamped between one
        request and the dense reservation."""
        ps = self.page_size
        dense_pages = self.max_batch * self.pages_per_slot
        demands = [
            min(self.pages_per_slot, -(-(len(r.prompt) + r.max_new_tokens) // ps))
            for r in pending
        ] or [self.pages_per_slot]
        per_req = max(demands)
        conc = max(1, min(self.max_batch, len(pending)))
        want = sum(sorted(demands)[-conc:]) + per_req + self.stats.pages_in_use
        return max(per_req, min(dense_pages, want))

    def on_submit(self, pending: list) -> None:
        """Adaptive pool sizing, deferred to first (non-empty) submit so the
        queue depth is known; later submits can only grow the pool, up to
        the dense reservation."""
        if not self._adaptive or not pending:
            return
        if self.cache is None:
            self._init_paged_pool(None, len(pending), pending)
            return
        want = self._adaptive_pages(pending)
        if want > self.n_pages:
            # geometric step (>= 1.5x): a stream of growing jobs pays
            # O(log) pool copies, not one per submit
            dense_pages = self.max_batch * self.pages_per_slot
            self._grow_pool(
                min(dense_pages,
                    max(want, self.n_pages + -(-self.n_pages // 2))),
                len(pending),
            )

    def _grow_pool(self, new_n: int, queue_depth: int) -> None:
        """Extend an adaptively-sized pool (existing pages keep their ids).
        The sentinel moves from the old to the new ``n_pages`` in the table
        shadow, which is re-pushed before the next dispatch."""
        old = self.n_pages
        for name in [n for n in self.cache if n.endswith("_pages")]:
            leaf = self.cache[name]
            pad = torch.zeros(
                leaf.shape[:1] + (new_n - old,) + leaf.shape[2:],
                dtype=leaf.dtype, device=leaf.device,
            )
            self.cache[name] = torch.cat([leaf, pad], dim=1)
        self.n_pages = new_n
        self._free_pages.extend(range(old, new_n))
        self._page_refs.extend([0] * (new_n - old))
        self._table[self._table == old] = new_n
        self._table_dirty = True
        _LOG.info(
            "paged pool grown adaptively: %d -> %d pages (queue depth %d)",
            old, new_n, queue_depth,
        )

    # ------------------------------------------------------- page allocator
    @property
    def peak_cache_bytes(self) -> int:
        """High-water cache footprint: pages actually resident (paged) or
        the whole dense reservation."""
        if self.cache_mode != "paged":
            return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(self.cache))
        return self.stats.peak_pages * self.stats.page_bytes

    def _incref(self, pid: int) -> None:
        """Add a reference (stitch / cache adoption), tracking the shared
        high-water mark at the 1 -> 2 transition."""
        self._page_refs[pid] += 1
        if self._page_refs[pid] == 2:
            self.stats._shared_pages += 1
            if self.stats._shared_pages > self.stats.pages_shared_peak:
                self.stats.pages_shared_peak = self.stats._shared_pages

    def _decref(self, pid: int) -> None:
        """Drop one reference; the page returns to the free list only when
        its last holder (slot or prefix cache) lets go."""
        self._page_refs[pid] -= 1
        if self._page_refs[pid] < 0:  # allocator invariant
            raise AssertionError(f"page {pid} refcount went negative")
        if self._page_refs[pid] == 1:
            self.stats._shared_pages -= 1
        elif self._page_refs[pid] == 0:
            self._free_pages.append(pid)  # LIFO: reuse hot pages
            self.stats.pages_in_use -= 1

    def _take_free_page(self) -> Optional[int]:
        """Pop a free page (refcount 1) without recovery and without peak
        tracking (callers record the high-water mark once their batch of
        allocations settles).  None when the free list is empty."""
        if not self._free_pages:
            return None
        pid = self._free_pages.pop()
        self._page_refs[pid] = 1
        self.stats.pages_in_use += 1
        self.stats.page_allocs += 1
        return pid

    def _evict(self, want: int) -> None:
        """Release up to ``want`` LRU cached prefix pages nobody maps."""
        evicted = self.prefix.evict(want, lambda p: self._page_refs[p])
        for pid in evicted:
            self._decref(pid)  # cache ownership -> free list
        self.stats.prefix_evictions += len(evicted)

    def _alloc_page(self, row: int) -> Optional[int]:
        """Claim a free page for ``row`` (refcount 1).

        On exhaustion, recover in escalating order: evict LRU cached
        prefixes nobody maps, then ask the scheduler (``preempt_for``) to
        preempt the youngest active slot strictly younger than the
        requester.  A ``YIELD`` answer returns ``None``: the caller unwinds
        and requeues the row through :meth:`_yield_row`.  Raises only when
        a lone request cannot fit in the entire pool."""
        while not self._free_pages:
            if self.prefix is not None:
                before = len(self._free_pages)
                self._evict(1)
                if len(self._free_pages) > before:
                    continue
            victim = self.preempt_for(row)
            if victim is None:
                raise RuntimeError(
                    f"paged KV pool exhausted ({self.n_pages} pages of "
                    f"{self.page_size} tokens) with nothing evictable or "
                    "preemptable; raise total_pages or lower request length"
                )
            if victim < 0 or victim == row:
                return None  # requester must yield (see _yield_row)
        return self._take_free_page()

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate one physical page across every layer
        and pool leaf, in place."""
        for leaf in self._pool_leaves().values():
            leaf[:, dst] = leaf[:, src]

    def ensure_pages(
        self, row: int, n_tokens: int, write_start: Optional[int] = None
    ) -> bool:
        """Back row ``row``'s first ``n_tokens`` positions with physical
        pages (allocate-on-write, ahead of every dispatch that writes
        them).  Any page in the write range (from ``write_start``) that
        another holder still references is first copied to a private page,
        so shared pages are immutable once published.  Returns False when
        the row was yielded back to the queue (or preempted by another
        row's recovery); the caller drops it from this tick's dispatch."""
        need = -(-n_tokens // self.page_size)
        if need > self.pages_per_slot:
            raise ValueError(
                f"request needs {n_tokens} cache positions but max_len="
                f"{self.max_len} caps a slot at {self.pages_per_slot} pages "
                f"of {self.page_size} tokens"
            )
        pages = self._slot_pages[row]
        shortfall = (need - len(pages)) - len(self._free_pages)
        if write_start is not None:
            # the CoW pass below also allocates one page per shared page in
            # the write range: count those into the bulk reclaim
            shortfall += sum(
                1
                for j in range(min(write_start // self.page_size, len(pages)),
                               min(need, len(pages)))
                if self._page_refs[pages[j]] > 1
            )
        if shortfall > 0 and self.prefix is not None:
            self._evict(shortfall)  # one radix pass for the whole shortfall
        while len(pages) < need:
            pid = self._alloc_page(row)
            if pid is None:
                return self._yield_row(row)
            self._table[row, len(pages)] = pid
            pages.append(pid)
            self._table_dirty = True
        if write_start is not None:
            for j in range(write_start // self.page_size, need):
                old = pages[j]
                if self._page_refs[old] > 1:  # shared: copy before write
                    new = self._alloc_page(row)
                    if new is None:
                        return self._yield_row(row)
                    self._copy_page(old, new)
                    self._decref(old)  # still >= 1: another slot / the cache
                    pages[j] = new
                    self._table[row, j] = new
                    self._table_dirty = True
                    self.stats.cow_copies += 1
        if self.stats.pages_in_use > self.stats.peak_pages:
            self.stats.peak_pages = self.stats.pages_in_use
        return True

    def reserve_speculative(
        self, row: int, base_tokens: int, want_tokens: int,
        write_start: Optional[int] = None,
    ) -> Optional[int]:
        """Back ``base_tokens`` positions with full :meth:`ensure_pages`
        recovery (eviction, preemption, yield: what the non-speculative
        dispatch would have demanded), then extend the backing toward
        ``want_tokens`` best-effort, from free pages and prefix eviction
        only: draft positions are optional, so their pages never preempt
        another slot or raise pool exhaustion.

        Returns the number of positions backed (``>= base_tokens``), or
        ``None`` when the row could not get its base demand and was
        yielded or preempted; the caller drops it from the dispatch."""
        if not self.ensure_pages(row, base_tokens, write_start=write_start):
            return None
        pages = self._slot_pages[row]
        want = min(-(-want_tokens // self.page_size), self.pages_per_slot)
        while len(pages) < want:
            pid = self._take_free_page()
            if pid is None and self.prefix is not None:
                self._evict(1)
                pid = self._take_free_page()
            if pid is None:
                break
            self._table[row, len(pages)] = pid
            pages.append(pid)
            self._table_dirty = True
        # a trailing page the row holds but shares caps the drafts at its
        # boundary: writing it would force a copy, which drafts are not worth
        backed = len(pages)
        for j in range(-(-base_tokens // self.page_size), len(pages)):
            if self._page_refs[pages[j]] > 1:
                backed = j
                break
        if self.stats.pages_in_use > self.stats.peak_pages:
            self.stats.peak_pages = self.stats.pages_in_use
        return max(base_tokens, backed * self.page_size)

    def _yield_row(self, row: int) -> bool:
        """The requester is the youngest active slot and nothing could be
        freed for it: it yields, after the allocation loop unwound.  The
        scheduler requeues the request at the queue front; deterministic
        sampling streams make the rerun byte-identical.  Always False."""
        self.preempt_row(row)
        return False

    def can_admit(self) -> bool:
        """Admission control under pool pressure: admitting into a pool with
        neither a free page nor an evictable cached page can only yield
        straight back to the queue, so hold the queue until one exists."""
        if self.cache_mode != "paged" or self.cache is None or self._free_pages:
            return True
        return self.prefix is not None and self.prefix.evictable(
            lambda p: self._page_refs[p]
        )

    def release_slot(self, row: int) -> None:
        """Drop the slot's references (shared/cached pages stay resident)
        and reset its table row to the sentinel so a stale write is
        masked out of the next dispatch."""
        if self.cache_mode != "paged" or self.cache is None:
            return
        pages = self._slot_pages[row]
        if not pages:
            return
        for pid in reversed(pages):
            self._decref(pid)
        self._slot_pages[row] = []
        self._table[row, :] = self.n_pages
        self._table_dirty = True

    def rewind_slot(self, row: int, n_tokens: int) -> None:
        """Speculative rollback: shrink the row's backing to its first
        ``n_tokens`` positions after a verify dispatch accepted fewer
        tokens than it wrote.  Whole pages past the new frontier are
        dropped (decref) and their table entries set to the sentinel;
        rejected tokens inside the kept tail page sit past the rewound
        frontier, where the causal mask excludes them, until the next
        dispatch overwrites them.  The dense cache has nothing to do."""
        if self.cache_mode != "paged" or self.cache is None:
            return
        keep = -(-n_tokens // self.page_size)
        pages = self._slot_pages[row]
        while len(pages) > keep:
            pid = pages.pop()
            self._table[row, len(pages)] = self.n_pages
            self._table_dirty = True
            self._decref(pid)

    def reset_row(self, row: int) -> None:
        """Prepare a row for a fresh admission.  Dense mode zeroes the row
        of every cache leaf, in place: every decode dispatch advances every
        row's recurrence, parked rows included, so only this makes a new
        request's SSM state start clean.  Paged mode has nothing to do (the
        row's pages went back at finish, its table row is the sentinel, and
        stale data inside a reallocated page sits past the new owner's write
        frontier where the causal mask excludes it)."""
        if self.cache_mode == "paged":
            return
        for leaf in tree_leaves(self.cache):
            if leaf.dim() >= 2 and leaf.shape[1] == self.max_batch:
                leaf[:, row].zero_()

    # --------------------------------------------------------- prefix cache
    def stitch_prefix(self, row: int, slot: Slot) -> None:
        """Admission-time prefix reuse (see :meth:`_stitch`).  Handoff
        admissions (``slot.req.handoff``) run the demand-driven hydration
        variant (the chain pages are expected to exist, so the walk may
        evict unpinned cached prefixes for room) and are accounted here:
        one ``hydration_ticks`` sample (store round-trips this admission
        made) and a ``handoff_fallbacks`` count when the store could not
        cover the prompt down to the held-back frontier token (the rest
        is chunk-prefilled, writing the same KV)."""
        demand = bool(slot.req.handoff) and self.store is not None
        if not demand:
            self._stitch(row, slot, False)
            return
        ops0 = self.store.fetch_ops
        self._stitch(row, slot, True)
        self.stats._hydration_ticks.append(self.store.fetch_ops - ops0)
        # a guaranteed hit leaves exactly the held-back frontier token to
        # re-dispatch; anything longer means the store could not cover it
        if len(slot.remaining_prompt) > 1:
            self.stats.handoff_fallbacks += 1
        self._sync_store_stats()

    def _stitch(self, row: int, slot: Slot, demand: bool) -> None:
        """Map the longest cached prefix of the new request's prompt into
        its page table and skip prefill for those tokens.  With a store
        attached, a local radix miss first tries to hydrate pages other
        workers published.  At least one prompt token is always held back
        and re-dispatched (its logits seed generation), so a full-prompt
        hit rewrites one position inside the last shared page, which
        copy-on-write then privatizes.

        With ``prefix_match="token"`` the longest common *token* prefix
        inside the first divergent page is reused too, by copying the
        partially-matched page into a slot-private page (best-effort: a
        free page or one LRU eviction, never preemption), or by fetching
        that sub-page tail from the store under its extended content key
        (a drained slot's published generation)."""
        if self.prefix is None:
            return
        prompt = slot.req.prompt

        def lookup():
            # page mode must not even scan for a partial sibling: the scan
            # refreshes its LRU stamp and would perturb the eviction order
            if self.prefix_match == "token":
                return self.prefix.match_partial(prompt)
            return self.prefix.match(prompt), None, 0

        path, pnode, plen = lookup()
        if self.store is not None:
            n_chunks = min(len(prompt) // self.page_size, self.pages_per_slot)
            if len(path) < n_chunks and self._hydrate(prompt, [n.page for n in path],
                                                      n_chunks, demand):
                path, pnode, plen = lookup()  # now extended locally
        path = path[: self.pages_per_slot]
        matched = len(path) * self.page_size
        eff = min(matched, len(prompt) - 1)
        # sub-page candidate: tokens reusable inside the first divergent
        # page, capped by the hold-back and dropped when the slot's table
        # has no room for the CoW page
        partial = 0
        if (
            self.prefix_match == "token"
            and pnode is not None
            and len(path) < self.pages_per_slot
        ):
            partial = min(plen, len(prompt) - 1 - matched)
        # extended-key tail hydration: another worker may have published
        # exactly this sub-page remainder under its extended content key
        # (publish_generation does).  Fetched into a slot-private page it
        # turns a resume's whole frontier into a hit; the held-back token's
        # rewrite lands inside the private page.  Free list only (demand
        # hydration may evict), and skipped when a local partial sibling
        # covers at least as many tokens
        tail_pid = None
        rem = list(prompt[matched:])
        if (
            self.store is not None
            and self.prefix_match == "token"
            and len(path) < self.pages_per_slot
            and 0 < len(rem) < self.page_size
            and len(rem) - 1 > partial
        ):
            parent = self._chunk_keys(prompt, len(path))[-1] if path else self.store.root_key()
            tkey = self.store.child_key(parent, rem)
            arrays = self.store.fetch(tkey, self._page_like())
            self._sync_store_stats()
            if arrays is not None:
                pid = self._take_free_page()
                if pid is None and demand and self.prefix is not None:
                    # pin the matched path with transient raw refcount bumps
                    # so the eviction cannot reclaim the chain mid-stitch
                    for n in path:
                        self._page_refs[n.page] += 1
                    try:
                        self._evict(1)
                    finally:
                        for n in path:
                            self._page_refs[n.page] -= 1
                    pid = self._take_free_page()
                if pid is not None:
                    self._write_page(pid, arrays)
                    tail_pid = pid
                    partial = len(rem) - 1
                    self._published.add(tkey)
                    self.stats.prefix_store_pages_hydrated += 1
                    self.stats.prefix_store_tokens_hydrated += partial
        if eff <= 0 and partial <= 0:
            return
        pages = self._slot_pages[row]
        for j, node in enumerate(path):
            self._incref(node.page)
            self._table[row, j] = node.page
            pages.append(node.page)
        if partial > 0:
            if tail_pid is not None:
                pid = tail_pid
            else:
                pid = self._cow_partial(pnode.page)
                if pid is not None:
                    self.stats.cow_partial_stitches += 1
            if pid is None:
                partial = 0  # no page to copy into: page-aligned fallback
            else:
                self._table[row, len(path)] = pid
                pages.append(pid)
                eff += partial
                slot.hit_tokens_partial = partial
                self.stats.prefix_hit_tokens_partial += partial
                if self.stats.pages_in_use > self.stats.peak_pages:
                    self.stats.peak_pages = self.stats.pages_in_use
        if eff <= 0:
            return
        self._table_dirty = True
        slot.pos = eff
        slot.remaining_prompt = list(prompt[eff:])
        slot.hit_tokens = matched
        slot.skipped_tokens = eff
        self.stats.prefix_hit_tokens += matched
        self.stats.prompt_tokens_skipped += eff

    def _cow_partial(self, src: int) -> Optional[int]:
        """Copy the partially-matched page ``src`` into a fresh private page
        (refcount 1): the free list, then one LRU eviction, never
        preemption.  ``src`` is pinned by a transient raw refcount bump so
        the eviction cannot reclaim the very page being copied (the stitch
        already holds the matched path's pages, hydrated ones included)."""
        self._page_refs[src] += 1
        try:
            pid = self._take_free_page()
            if pid is None and self.prefix is not None:
                self._evict(1)
                pid = self._take_free_page()
            if pid is not None:
                self._copy_page(src, pid)
            return pid
        finally:
            self._page_refs[src] -= 1

    def prefix_insert(self, row: int, prompt: List[int]) -> None:
        """Publish a freshly-ingested prompt's full pages to the radix cache
        (called the moment the prompt is fully resident).  Chunks already
        cached keep the cache's page; only newly adopted pages gain the
        cache's ref.  With a store attached, the full chunks are also
        published under their chained content keys."""
        if self.prefix is None:
            return
        n_full = min(len(prompt) // self.page_size, len(self._slot_pages[row]))
        if n_full == 0:
            return
        pages = self._slot_pages[row][:n_full]
        for pid in self.prefix.insert(prompt, pages):
            self._incref(pid)
        if self.store is not None:
            self._publish(prompt, pages, n_full)

    # ----------------------------------------------- cross-host prefix store
    def _page_arrays(self, pid: int) -> Dict[str, np.ndarray]:
        """One page's slice of every pool leaf, pulled to host numpy."""
        return {name: host_page(leaf[:, pid]) for name, leaf in self._pool_leaves().items()}

    def _page_like(self) -> Dict[str, np.ndarray]:
        """Shape/dtype template a fetched page must match exactly."""
        return {
            name: np.empty(leaf.shape[:1] + leaf.shape[2:], host_dtype(leaf.dtype))
            for name, leaf in self._pool_leaves().items()
        }

    def _write_page(self, pid: int, arrays: Dict[str, np.ndarray]) -> None:
        """Hydrate pool page ``pid`` from fetched host arrays.  The copy
        from pageable host memory returns once the source is consumed and
        is ordered before the next dispatch on the engine's stream."""
        for name, leaf in self._pool_leaves().items():
            leaf[:, pid].copy_(device_page(arrays[name], leaf.dtype))

    def _publisher_for(self):
        if self._publisher is None:
            self._publisher = self.store.publisher()
        return self._publisher

    def _chunk_keys(self, prompt: List[int], n_chunks: int) -> List[str]:
        """Chained content keys for the first ``n_chunks`` full chunks."""
        ps = self.page_size
        keys, key = [], self.store.root_key()
        for j in range(n_chunks):
            key = self.store.child_key(key, prompt[j * ps:(j + 1) * ps])
            keys.append(key)
        return keys

    def _publish(self, prompt: List[int], pages: List[int], n_full: int) -> None:
        if len(self._published) > 100_000:
            # the memo only saves round-trips; resetting it is always safe
            # and bounds a long-lived engine on diverse traffic
            self._published.clear()
        for j, key in enumerate(self._chunk_keys(prompt, n_full)):
            if key in self._published:
                continue
            if not self.store.exists(key):
                # one existence probe, then an unconditional write.  The
                # device->host pull happens at submit time, on this thread
                # (the pool page may be reissued before the write lands),
                # passed as a thunk so a submit the publisher dedups skips
                # the pull and the pack entirely
                self._publisher_for().submit(key, lambda pid=pages[j]: self._page_arrays(pid))
                self.stats.prefix_store_pages_published += 1
            self._published.add(key)

    def publish_generation(self, row: int, tokens: List[int]) -> int:
        """Publish a drained slot's resident KV — full chunks under the
        usual chained keys plus the sub-page tail under an extended content
        key — so a resuming worker gets a guaranteed prefix hit over
        ``tokens`` (the request's prompt + output minus the frontier
        token).  Returns the number of pages newly submitted."""
        if self.store is None or self.cache_mode != "paged" or self.cache is None:
            return 0
        ps = self.page_size
        pages = self._slot_pages[row]
        before = self.stats.prefix_store_pages_published
        n_full = min(len(tokens) // ps, len(pages))
        if n_full:
            self._publish(tokens, pages[:n_full], n_full)
        tail = tokens[n_full * ps:]
        if tail and n_full < len(pages):
            parent = self._chunk_keys(tokens, n_full)[-1] if n_full else self.store.root_key()
            tkey = self.store.child_key(parent, tail)
            if tkey not in self._published and not self.store.exists(tkey):
                # the tail blob carries the whole physical page; rows past
                # the tail are garbage a hydrating reader never attends to
                # (causal mask), and its held-back re-dispatch overwrites
                # the frontier position
                self._publisher_for().submit(
                    tkey, lambda pid=pages[n_full]: self._page_arrays(pid))
                self.stats.prefix_store_pages_published += 1
            self._published.add(tkey)
        return self.stats.prefix_store_pages_published - before

    def chain_keys_for(self, tokens: List[int]) -> List[str]:
        """Content keys covering ``tokens``: every full chunk plus, when a
        sub-page remainder exists, its extended tail key — the exact set a
        handoff's demand hydration fetches.  The prefill lease pins these
        against the TTL sweep before enqueueing a handoff."""
        if self.store is None:
            return []
        n_full = len(tokens) // self.page_size
        keys = self._chunk_keys(tokens, n_full)
        tail = tokens[n_full * self.page_size:]
        if tail:
            parent = keys[-1] if n_full else self.store.root_key()
            keys.append(self.store.child_key(parent, tail))
        return keys

    def ensure_chain_published(self, row: int, tokens: List[int]) -> List[str]:
        """Re-probe and (re)submit every chain page covering ``tokens``
        while row ``row`` still holds them, bypassing the ``_published``
        memo (which means "submitted", not "durable": a handoff points
        other workers at these exact keys).  A key whose queued write has
        not landed probes as absent and is resubmitted; the publisher's
        pending-key dedup drops the duplicate before any pull or pack
        (``publish_dedup_hits``).  Returns the chain keys."""
        if self.store is None or self.cache_mode != "paged" or self.cache is None:
            return []
        ps = self.page_size
        pages = self._slot_pages[row]
        n_full = min(len(tokens) // ps, len(pages))
        keys = self._chunk_keys(tokens, n_full)
        publisher = self._publisher_for()
        for j, key in enumerate(keys):
            if not self.store.exists(key):
                publisher.submit(key, lambda pid=pages[j]: self._page_arrays(pid))
        tail = tokens[n_full * ps:]
        if tail and n_full < len(pages):
            parent = keys[-1] if n_full else self.store.root_key()
            tkey = self.store.child_key(parent, tail)
            keys.append(tkey)
            if not self.store.exists(tkey):
                publisher.submit(tkey, lambda pid=pages[n_full]: self._page_arrays(pid))
        self._sync_store_stats()
        return keys

    def _sync_store_stats(self) -> None:
        """Mirror the store/publisher-owned counters into the shared stats
        block (they live on PrefixStore/AsyncPublisher so the store path
        has no stats dependency)."""
        if self.store is not None:
            self.stats.prefix_store_hash_mismatches = self.store.hash_mismatches
            self.stats.hydration_fetch_ops = self.store.fetch_ops
            self.stats.prefix_store_bytes_fetched = self.store.bytes_fetched
        if self._publisher is not None:
            self.stats.publish_retries = self._publisher.retries
            self.stats.publish_dedup_hits = self._publisher.dedup_hits

    def flush_store(self) -> None:
        """Drain the background publish queue (a no-op without a store or
        before the first publish).  Called at the engine's drain seams so
        published pages are durable before counters are compared or the
        process exits."""
        if self._publisher is not None:
            self._publisher.flush()
        self._sync_store_stats()

    def _hydrate(self, prompt: List[int], pages_so_far: List[int], n_chunks: int,
                 demand: bool) -> int:
        """Extend the local radix path for ``prompt`` (already covering
        ``pages_so_far`` chunks) from the store: fetch chunk pages other
        workers published, copy them into freshly allocated pool pages and
        index them, so the stitch that follows hits locally.  Stops at the
        first miss.  Returns the pages hydrated.

        Plain hydration is best-effort and side-effect-free on other
        slots: it only takes already-free pages and stops when the free
        list runs dry.  ``demand`` (handoff admissions: the chain is
        expected to exist, a prefill worker just published and pinned it)
        may evict unpinned LRU cached prefixes for room, never preempting;
        pages already matched or freshly hydrated are pinned by transient
        raw refcount bumps so the eviction cannot reclaim the chain being
        assembled."""
        ps = self.page_size
        keys = self._chunk_keys(prompt, n_chunks)
        like = self._page_like()
        pages_so_far = list(pages_so_far)
        hydrated = 0
        pinned: List[int] = []
        try:
            if demand:
                for p in pages_so_far:
                    self._page_refs[p] += 1
                    pinned.append(p)
            for j in range(len(pages_so_far), n_chunks):
                arrays = self.store.fetch(keys[j], like)
                if arrays is None:
                    break
                self._published.add(keys[j])  # a fetched page is in the store
                pid = self._take_free_page()
                if pid is None and demand and self.prefix is not None:
                    self._evict(1)
                    pid = self._take_free_page()
                if pid is None:
                    break
                self._write_page(pid, arrays)
                pages_so_far.append(pid)
                if demand:
                    self._page_refs[pid] += 1
                    pinned.append(pid)
                hydrated += 1
        finally:
            for p in pinned:
                self._page_refs[p] -= 1
        if hydrated:
            # the allocation above IS the cache's refcount on each hydrated
            # page (insert adopts them; nothing further to incref)
            self.prefix.insert(prompt[: len(pages_so_far) * ps], pages_so_far)
            self.stats.prefix_store_pages_hydrated += hydrated
            self.stats.prefix_store_tokens_hydrated += hydrated * ps
            if self.stats.pages_in_use > self.stats.peak_pages:
                self.stats.peak_pages = self.stats.pages_in_use
        return hydrated

    # ------------------------------------------------------------ debugging
    def check_invariants(self) -> None:
        """Assert the allocator's structural invariants: refcount ==
        holders (slot tables + the radix cache), no slot maps a page
        twice, the free list is exactly the refcount-0 pages, the table
        shadow mirrors the slot page lists, and ``pages_in_use`` equals
        the pool size minus free pages.  The dense cache has none."""
        if self.cache_mode != "paged" or self.cache is None:
            return
        holders = [0] * self.n_pages
        for row, pages in enumerate(self._slot_pages):
            if len(set(pages)) != len(pages):
                raise AssertionError(f"slot {row} maps a physical page twice: {pages}")
            for j, pid in enumerate(pages):
                holders[pid] += 1
                if self._table[row, j] != pid:
                    raise AssertionError(
                        f"table shadow desync at slot {row} page {j}: "
                        f"table={self._table[row, j]} list={pid}"
                    )
            if not np.all(self._table[row, len(pages):] == self.n_pages):
                raise AssertionError(
                    f"slot {row}: table rows past its {len(pages)}-page "
                    "backing are not the sentinel"
                )
        cached = set(self.prefix.pages()) if self.prefix is not None else set()
        for pid in range(self.n_pages):
            expect = holders[pid] + (1 if pid in cached else 0)
            if self._page_refs[pid] != expect:
                raise AssertionError(
                    f"page {pid}: refcount {self._page_refs[pid]} != {expect} holder(s)"
                )
        free = self._free_pages
        if len(set(free)) != len(free):
            raise AssertionError("free list contains duplicates")
        if any(self._page_refs[pid] != 0 for pid in free):
            raise AssertionError("a free page has a nonzero refcount")
        if sum(1 for r in self._page_refs if r == 0) != len(free):
            raise AssertionError("refcount-0 pages and the free list disagree")
        if self.stats.pages_in_use != self.n_pages - len(free):
            raise AssertionError(
                f"pages_in_use={self.stats.pages_in_use} != "
                f"{self.n_pages - len(free)} resident pages"
            )

    # ------------------------------------------------------------- dispatch
    def push_table(self) -> None:
        """Copy the host page table to the device before a dispatch (the
        dense cache has none)."""
        if self.cache_mode == "paged" and self._table_dirty:
            self.cache["page_table"].copy_(torch.from_numpy(self._table))
            self._table_dirty = False
