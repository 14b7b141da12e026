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
the page copy, and the page-table push.  Both caches are updated in
place.  The cross-host prefix store is not ported (ROADMAP Queue 1).

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
  becomes fully resident the executor calls :meth:`prefix_insert`.

Allocator invariants (checked by :meth:`check_invariants`): a page's
refcount equals the number of slot tables mapping it plus one if the
radix cache indexes it; a page returns to the free list exactly at
refcount zero; after a full drain ``pages_in_use`` equals the pages the
radix cache retains, each at refcount 1.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.serving.prefix_cache import PrefixCache
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
            for leaf in self._pool_leaves()
        )
        self.stats.dense_cache_bytes = dense_pages * self.stats.page_bytes

    def _pool_leaves(self) -> List[torch.Tensor]:
        return [leaf for name, leaf in self.cache.items() if name.endswith("_pages")]

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
        for leaf in self._pool_leaves():
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
        """Admission-time prefix reuse: map the longest cached prefix of the
        new request's prompt into its page table and skip prefill for those
        tokens.  At least one prompt token is always held back and re-
        dispatched (its logits seed generation), so a full-prompt hit
        rewrites one position inside the last shared page, which copy-on-
        write then privatizes.

        With ``prefix_match="token"`` the longest common *token* prefix
        inside the first divergent page is reused too, by copying the
        partially-matched page into a slot-private page (best-effort: a
        free page or one LRU eviction, never preemption)."""
        if self.prefix is None:
            return
        prompt = slot.req.prompt
        # page mode must not even scan for a partial sibling: the scan
        # refreshes its LRU stamp and would perturb the eviction order
        if self.prefix_match == "token":
            path, pnode, plen = self.prefix.match_partial(prompt)
        else:
            path, pnode, plen = self.prefix.match(prompt), None, 0
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
        if eff <= 0 and partial <= 0:
            return
        pages = self._slot_pages[row]
        for j, node in enumerate(path):
            self._incref(node.page)
            self._table[row, j] = node.page
            pages.append(node.page)
        if partial > 0:
            pid = self._cow_partial(pnode.page)
            if pid is None:
                partial = 0  # no page to copy into: page-aligned fallback
            else:
                self.stats.cow_partial_stitches += 1
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
        the eviction cannot reclaim the very page being copied."""
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
        cache's ref."""
        if self.prefix is None:
            return
        n_full = min(len(prompt) // self.page_size, len(self._slot_pages[row]))
        if n_full == 0:
            return
        for pid in self.prefix.insert(prompt, self._slot_pages[row][:n_full]):
            self._incref(pid)

    def publish_generation(self, row: int, tokens: List[int]) -> int:
        """Publish a drained slot's resident KV for a resuming worker: the
        reference does it through its cross-host prefix store, which the
        port does not have yet (ROADMAP Queue 1), so, as the reference
        without a store, nothing is published.  Returns the number of
        pages published: 0."""
        return 0

    def flush_store(self) -> None:
        """The reference's drain seam for background prefix-store
        publishes; a no-op without a store."""

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
