"""Shared-prefix radix cache over the paged KV pool (a copy of the
reference package's framework-free ``serving/prefix_cache.py``).

The serving engine's paged allocator is strictly per-slot: a
batch of N requests sharing a system prompt prefills and stores the
same KV pages N times.  This module is the host-side index that turns
those pages into shared infrastructure — the same amortize-the-common-
cost move the paper makes for clusters and Juve et al. make for
workflow data: store shared state once, reference it many times.

Structure: a radix tree keyed on *token-aligned page-size chunks*.
Each node is one full KV page — ``page_size`` consecutive prompt
tokens starting at a page-aligned offset — and holds the physical page
id that backs that chunk in the engine's pool.  A path from the root
spells out a prompt prefix at page granularity, so matching a new
prompt is a walk down the tree and every matched node is a page the
new request can reference instead of recomputing.

Ownership contract (the cache is an *index*, not the allocator):

- The cache never allocates or frees pages.  The engine's refcounted
  allocator owns page lifetime; a node's page carries one refcount held
  *by the cache* (taken when ``insert`` adopts the page, released when
  ``evict`` removes the node).  Active slots referencing the same page
  hold their own refcounts on top.
- Only **full** chunks are indexed: a page is inserted only once every
  one of its ``page_size`` positions holds a real prompt token, so a
  matched page can be referenced as-is.  Partial tail pages stay
  private to their slot.
- Matching is not limited to whole pages: ``match_partial`` also
  reports the longest common *token* prefix between the prompt's first
  divergent chunk and the cached chunks branching at that point, so
  the engine can copy-on-write the partially-matched page and resume
  prefill from a mid-page offset (sub-page prefix reuse).
- Eviction removes LRU **leaves** whose page the cache alone still
  references (``ref_of(page) == 1``): an interior node can only be
  evicted after its subtree, and a page some active slot still maps
  stays resident no matter how cold it looks.

The tree never touches device memory; stitching a hit into a slot's
page table and copy-on-write of shared pages are the engine's job
(`repro_torch.serving.cache_manager`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

Chunk = Tuple[int, ...]


class RadixNode:
    """One cached KV page: ``key`` = its page_size tokens, ``page`` = the
    physical page id in the engine's pool holding their K/V."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Chunk, page: int, parent: "RadixNode | None"):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Chunk, RadixNode] = {}
        self.last_used = 0


class PrefixCache:
    """Radix index of cached prompt prefixes at page granularity."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.page_size = int(page_size)
        self.root = RadixNode((), -1, None)
        self.n_nodes = 0
        self._clock = 0  # LRU timestamp source, bumped per operation

    # ------------------------------------------------------------ helpers
    def _chunks(self, tokens: Sequence[int]) -> List[Chunk]:
        """Full page-size chunks of ``tokens`` (partial tail dropped)."""
        ps = self.page_size
        end = len(tokens) - len(tokens) % ps
        return [tuple(tokens[i : i + ps]) for i in range(0, end, ps)]

    # ------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> List[RadixNode]:
        """Longest cached prefix of ``tokens``, as the node path from the
        root.  ``len(path) * page_size`` tokens are covered; the caller
        stitches ``[n.page for n in path]`` into a slot's page table."""
        self._clock += 1
        node, path = self.root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = self._clock
            path.append(child)
            node = child
        return path

    def match_partial(
        self, tokens: Sequence[int]
    ) -> Tuple[List[RadixNode], "RadixNode | None", int]:
        """Longest cached prefix of ``tokens`` at *token* granularity.

        Returns ``(path, partial, n_partial)``: ``path`` is the full-page
        node path (exactly :meth:`match`), and ``partial`` — when not
        None — is the child of the last matched node whose key shares
        the longest common token prefix (``n_partial >= 1`` tokens) with
        the prompt's first divergent chunk.  The caller cannot reference
        ``partial.page`` as-is (its tail belongs to another prompt); it
        copy-on-writes the page and resumes prefill mid-page.
        """
        path = self.match(tokens)
        node = path[-1] if path else self.root
        start = len(path) * self.page_size
        rest = tokens[start : start + self.page_size]
        best, best_len = None, 0
        if len(rest) > 0:
            for key, child in node.children.items():
                n = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    n += 1
                if n > best_len:
                    best, best_len = child, n
        if best is not None:
            best.last_used = self._clock
        return path, best, best_len

    # ------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> List[int]:
        """Index ``pages[j]`` as holding chunk ``j`` of ``tokens``.

        Chunks already present keep their existing page (first writer
        wins — a concurrent slot that prefilled the same prefix privately
        simply fails to donate; its copy is freed when it finishes).
        Returns the page ids newly adopted by the cache; the caller must
        add the cache's refcount to exactly those.
        """
        self._clock += 1
        node, adopted = self.root, []
        for chunk, pid in zip(self._chunks(tokens), pages):
            child = node.children.get(chunk)
            if child is None:
                child = RadixNode(chunk, int(pid), node)
                node.children[chunk] = child
                adopted.append(int(pid))
                self.n_nodes += 1
            child.last_used = self._clock
            node = child
        return adopted

    # ------------------------------------------------------------ evict
    def _evictable_leaves(self, ref_of: Callable[[int], int]):
        """DFS over leaves whose page only the cache references
        (``ref_of(page) == 1``) — the ONE definition of evictability,
        shared by :meth:`evict` and :meth:`evictable` so the admission
        gate can never disagree with what eviction can actually
        reclaim."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                elif ref_of(c.page) == 1:
                    yield c

    def evict(self, want: int, ref_of: Callable[[int], int]) -> List[int]:
        """Drop up to ``want`` LRU leaf nodes whose page only the cache
        still references (``ref_of(page) == 1``) and return their page
        ids; the caller releases the cache's refcount on each (freeing
        the page).  Pages mapped by any active slot are never returned.
        """
        out: List[int] = []
        while len(out) < want:
            # one DFS collects every currently evictable leaf; evicting a
            # whole LRU batch per pass keeps bulk recovery O(tree) per
            # exposed level instead of O(tree) per page
            victims = list(self._evictable_leaves(ref_of))
            if not victims:
                break  # nothing evictable: every leaf is in active use
            victims.sort(key=lambda v: v.last_used)
            for v in victims[: want - len(out)]:
                assert v.parent is not None
                del v.parent.children[v.key]
                self.n_nodes -= 1
                out.append(v.page)
        return out

    def evictable(self, ref_of: Callable[[int], int]) -> bool:
        """True when at least one leaf's page only the cache references
        — i.e. :meth:`evict` could reclaim a page right now.  Used by
        admission control: admitting a request when the pool has neither
        a free nor an evictable page can only yield straight back to the
        queue."""
        return next(self._evictable_leaves(ref_of), None) is not None

    # ------------------------------------------------------------ debug
    def pages(self) -> List[int]:
        """Every page id currently indexed (tests / accounting)."""
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                out.append(c.page)
                stack.append(c)
        return out
