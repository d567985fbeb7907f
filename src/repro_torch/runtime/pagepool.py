"""Host-side page allocator + shared-prefix cache for the paged KV cache.

The device holds the page POOLS (``k_pages``/``v_pages`` leaves, one
global pool per layer stack) and the (B, W) int32 ``page_table``; this
module owns the host bookkeeping that decides WHICH physical page a
lane's next logical block maps to:

* ``PagePool`` — free-list allocator over ``num_pages`` fixed-size
  pages with per-page refcounts.  Page 0 is the permanently reserved
  GARBAGE page: it is never handed out, and inactive lanes' zeroed
  table rows point at it so their (masked-out) decode writes land
  harmlessly instead of corrupting a reallocated page.

* Prefix cache — an LRU map from exact padded-prompt-token tuples (at
  page-aligned lengths, plus the full prompt length) to the page run
  holding that prefix's KV.  A hit lets admission map those pages
  read-only (refcount++) and prefill only the suffix; copy-on-write in
  the scheduler keeps cached entries pristine when a lane later writes
  into a shared page.

No jax imports — this is pure host Python/numpy; the scheduler turns
decisions into device updates.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

GARBAGE_PAGE = 0


@dataclass
class PrefixEntry:
    """One cached prefix: ``tokens`` (the exact key), the pages holding
    its KV (the entry owns one reference per page), and its token
    ``length`` (may end mid-page — the last page is then only partially
    covered, and a lane extending past it must COW it)."""
    tokens: Tuple[int, ...]
    pages: Tuple[int, ...]
    length: int


class PagePool:
    """Refcounted free-list allocator over a fixed page pool.

    ``num_pages`` counts ALL pages including the reserved garbage page
    0, matching the device pool's leading axis.
    """

    def __init__(self, num_pages: int, page_size: int, metrics=None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError(f"bad page_size {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # optional MetricsRegistry (duck-typed — still no jax here): the
        # scheduler passes its registry so allocator pressure events
        # (pool.evictions / pool.alloc_failures) land on the same stats
        # surface as everything else
        self.metrics = metrics
        self.refcount = np.zeros((num_pages,), np.int32)
        self.refcount[GARBAGE_PAGE] = 1          # pinned forever
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # LRU prefix cache: key -> PrefixEntry (key = (cut, tokens[:cut]))
        self._prefixes: "OrderedDict[tuple, PrefixEntry]" = OrderedDict()

    # -- allocation -------------------------------------------------------

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` pages (refcount 1 each) or None if the free list
        is short — the caller decides whether to evict prefixes or
        defer admission."""
        if n > len(self._free):
            self._count("pool.alloc_failures")
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0, (p, self.refcount[p])
            self.refcount[p] = 1
        return pages

    def ref(self, page: int) -> None:
        assert self.refcount[page] > 0, page
        self.refcount[page] += 1

    def free(self, page: int) -> None:
        """Drop one reference; the page returns to the free list when
        the count hits zero."""
        assert page != GARBAGE_PAGE, "freeing the garbage page"
        assert self.refcount[page] > 0, page
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)

    # -- prefix cache -----------------------------------------------------

    @staticmethod
    def _key(tokens: Sequence[int], cut: int) -> tuple:
        return (cut, tuple(int(t) for t in tokens[:cut]))

    def prefix_lookup(self, tokens: Sequence[int]) -> Optional[PrefixEntry]:
        """Longest cached prefix of ``tokens``: the full length first,
        then page-aligned cuts descending.  A hit is moved to the LRU
        tail (most recent)."""
        ps = self.page_size
        n = len(tokens)
        cuts = [n] + [c for c in range((n // ps) * ps, 0, -ps) if c < n]
        for cut in cuts:
            entry = self._prefixes.get(self._key(tokens, cut))
            if entry is not None:
                self._prefixes.move_to_end(self._key(tokens, cut))
                return entry
        return None

    def prefix_register(self, tokens: Sequence[int],
                        pages: Sequence[int]) -> None:
        """Publish every page-aligned prefix of ``tokens`` (and the full
        length) as cache entries over the lane's current ``pages``.
        Each NEW entry takes one reference per page it spans, so the
        pages outlive the lane that produced them."""
        ps = self.page_size
        n = len(tokens)
        cuts = list(range(ps, n, ps)) + [n]
        for cut in cuts:
            key = self._key(tokens, cut)
            if key in self._prefixes:
                self._prefixes.move_to_end(key)
                continue
            span = -(-cut // ps)
            entry = PrefixEntry(key[1], tuple(int(p) for p in pages[:span]),
                                cut)
            for p in entry.pages:
                self.ref(p)
            self._prefixes[key] = entry

    def evict_one(self) -> bool:
        """Drop the least-recently-used prefix entry (freeing its page
        references).  Returns False when the cache is empty."""
        if not self._prefixes:
            return False
        _, entry = self._prefixes.popitem(last=False)
        for p in entry.pages:
            self.free(p)
        self._count("pool.evictions")
        return True

    def prefix_entries(self) -> int:
        return len(self._prefixes)

    def entry_page_refs(self) -> np.ndarray:
        """Per-page reference counts held by prefix-cache entries — the
        scheduler's ``audit_pages`` combines this with the live lanes'
        page tables to reconstruct (and assert) the full refcounts."""
        refs = np.zeros(self.num_pages, np.int64)
        for entry in self._prefixes.values():
            for p in entry.pages:
                refs[p] += 1
        return refs

    def leak_check(self) -> None:
        """Every page is either free, garbage, or reachable from a live
        reference — asserts the refcount/free-list invariant (used by
        tests after admit/retire cycles)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free pages"
        for p in range(self.num_pages):
            if p == GARBAGE_PAGE:
                assert self.refcount[p] >= 1
                assert p not in free
            elif p in free:
                assert self.refcount[p] == 0, (p, self.refcount[p])
            else:
                assert self.refcount[p] > 0, f"leaked page {p}"
