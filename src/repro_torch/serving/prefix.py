"""Radix-style prefix index over admitted prompts (paged KV reuse); a copy
of the JAX package's ``serving/prefix.py``.

The index maps *page-aligned* token prefixes to per-page payloads (the
engine stores KV block ids; the disaggregated tier stores (prefill_block,
decode_block) pairs). Granularity is one KV page: a prompt contributes
``len(tokens) // page_size`` full pages, and a lookup returns the longest
chain of already-indexed pages matching the query's page sequence —
classic radix/trie longest-prefix-match, with one trie edge per page so
match/insert are O(pages), not O(tokens).

Eviction is LRU over *leaves only*: an interior page is by construction at
least as recently used as every descendant (any match or insert that
touches a node touches its whole root path), so evicting leaves first
releases the coldest pages while keeping the shared trunk hot. The caller
owns block lifetime — evicted payloads are returned for deref'ing, and the
refcounts in :class:`repro_torch.models.kvcache.PagedKVPool` guarantee a
block a live request still reads survives its index eviction.
"""

from __future__ import annotations

from typing import Optional


class _Node:
    __slots__ = ("key", "payload", "children", "parent", "last_use")

    def __init__(self, key, payload, parent):
        self.key = key  # page token tuple (None for root)
        self.payload = payload
        self.children = {}
        self.parent = parent
        self.last_use = 0


class RadixPrefixIndex:
    """Longest-prefix-match over page-aligned prompt prefixes.

    ``capacity_pages`` (optional) bounds the indexed page count; inserts
    beyond it evict LRU leaves first (the engine additionally evicts on
    KV-pool pressure).
    """

    def __init__(self, page_size: int, capacity_pages: Optional[int] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1: {page_size}")
        self.page = int(page_size)
        self.capacity_pages = capacity_pages
        self.root = _Node(None, None, None)
        self.n_pages = 0
        self._clock = 0
        # telemetry
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ #
    def _pages(self, tokens) -> list:
        toks = [int(t) for t in tokens]
        n = len(toks) // self.page
        return [tuple(toks[i * self.page:(i + 1) * self.page])
                for i in range(n)]

    def _touch(self, node) -> None:
        self._clock += 1
        while node is not None and node.key is not None:
            node.last_use = self._clock
            node = node.parent

    # ------------------------------------------------------------------ #
    def match(self, tokens, max_pages: Optional[int] = None, *,
              peek: bool = False) -> list:
        """Longest indexed page-chain prefixing ``tokens``.

        Returns the matched pages' payloads in order (possibly empty).
        ``max_pages`` caps the walk (the engine caps below the full prompt
        so at least one suffix token always remains to produce logits).
        ``peek`` skips the LRU touch and hit/miss counters — for router
        scoring, which must not distort replica-local recency.
        """
        pages = self._pages(tokens)
        if max_pages is not None:
            pages = pages[:max_pages]
        node = self.root
        out = []
        for pg in pages:
            child = node.children.get(pg)
            if child is None:
                break
            out.append(child.payload)
            node = child
        if not peek:
            if out:
                self.hits += 1
                self._touch(node)
            else:
                self.misses += 1
        return out

    def lookup_tokens(self, tokens) -> int:
        """Matched prefix length in TOKENS (LRU-neutral; router scoring)."""
        return len(self.match(tokens, peek=True)) * self.page

    # ------------------------------------------------------------------ #
    def insert(self, tokens, payloads, max_pages: Optional[int] = None) -> list:
        """Index ``tokens``' page chain; page ``i`` carries ``payloads[i]``.

        Existing pages keep their current payload (first writer wins — the
        engine refs THOSE blocks at match time instead). Returns the
        payloads of newly-created nodes, so the caller can take the index's
        block references. Respects ``capacity_pages`` by LRU-evicting
        leaves first; pages that still don't fit are skipped (deeper pages
        of a chain can never be indexed without their parents, so the walk
        stops).
        """
        pages = self._pages(tokens)
        if max_pages is not None:
            pages = pages[:max_pages]
        node = self.root
        created = []
        for i, pg in enumerate(pages):
            child = node.children.get(pg)
            if child is None:
                if self.capacity_pages is not None:
                    while (self.n_pages >= self.capacity_pages
                           and self.evict_lru()):
                        pass
                    if self.n_pages >= self.capacity_pages:
                        break
                child = _Node(pg, payloads[i], node)
                node.children[pg] = child
                self.n_pages += 1
                created.append(payloads[i])
            node = child
        self._touch(node)
        return created

    # ------------------------------------------------------------------ #
    def _leaves(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.key is not None and not n.children:
                yield n
            stack.extend(n.children.values())

    def evict_lru(self) -> Optional[object]:
        """Remove the least-recently-used LEAF page; returns its payload
        (None when the index is empty). One page per call so the caller
        can stop as soon as the KV pool has room again."""
        victim = None
        for leaf in self._leaves():
            if victim is None or leaf.last_use < victim.last_use:
                victim = leaf
        if victim is None:
            return None
        del victim.parent.children[victim.key]
        self.n_pages -= 1
        return victim.payload

    def clear(self) -> list:
        """Drop everything; returns all payloads (caller derefs blocks)."""
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.key is not None:
                out.append(n.payload)
            stack.extend(n.children.values())
        self.root = _Node(None, None, None)
        self.n_pages = 0
        return out
