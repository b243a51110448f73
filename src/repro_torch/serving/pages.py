"""Block-pool allocator for the paged KV cache: a copy of
``repro/serving/pages.py`` (stdlib only; ``tests/test_torch_core.py``
holds its code to the original).

The pool divides the physical cache (``num_pages`` fixed-size token
pages per layer, allocated once at engine start) into reference-counted
blocks.  Host-side and pure Python by design: allocation decisions are
control flow, not compute — the device only ever sees the resulting
page-table rows.

Three cooperating pieces:

* :class:`PagePool` — free list + per-page refcounts.  ``alloc`` hands
  out an exclusively-owned page; ``retain`` adds a sharer; ``release``
  returns the page to the free list when the last reference drops;
  ``writable`` is the copy-on-write gate: a page with one reference is
  returned as-is, a shared page is swapped for a fresh copy target (the
  caller copies the bytes — :meth:`repro_torch.models.Model.copy_cache_page`).
* :class:`PoolMetrics` — allocation/COW/preemption accounting in the
  same spirit as the engines' ``wire_bits`` counters: every byte of
  cache HBM the serving path holds is derivable from these numbers.
* :class:`PrefixCache` — the shared-prompt-prefix index.  Prefilled
  prompt pages are registered under the token prefix they cover; a new
  request walks its prompt page-by-page and shares every registered
  page it matches (full pages, plus at most one trailing partial page)
  instead of allocating fresh ones.  Cache entries hold their own
  reference, so shared pages survive their original request; entries
  are evicted LRU under pool pressure.

Invariants (property-tested in tests/test_pages.py):

* ``len(free) + |{p : ref[p] > 0}| == num_pages`` — pages are never
  lost or duplicated;
* a page is never simultaneously free and referenced;
* ``writable`` returns a page with refcount 1 that the caller may
  mutate; the shared original keeps its remaining references.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class PoolMetrics:
    """Cumulative pool accounting (wire_bits-style: everything the §11
    benchmark reports is computed from these counters)."""
    num_pages: int
    page_size: int
    allocs: int = 0
    frees: int = 0
    cow_copies: int = 0
    prefix_hits: int = 0           # pages shared instead of allocated
    prefix_evictions: int = 0
    preemptions: int = 0
    alloc_failures: int = 0
    peak_in_use: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PagePool:
    """Fixed-size page pool with refcounted sharing."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError("pool needs >= 1 page of >= 1 token")
        self.num_pages = num_pages
        self.page_size = page_size
        # pop() takes from the end: keep ascending ids at the tail so
        # fresh allocations walk the pool front to back (deterministic,
        # and the parity anchor maps slot i -> page i on first fill).
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * num_pages
        # bumped on every alloc: (pid, generation) names one *lifetime*
        # of a page, so stale prefix-chain links to a freed-and-reused
        # page can never resolve (PrefixCache key safety)
        self._gen: List[int] = [0] * num_pages
        self.metrics = PoolMetrics(num_pages=num_pages, page_size=page_size)

    # -- core ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def utilization(self) -> float:
        return self.in_use / self.num_pages

    def refcount(self, pid: int) -> int:
        return self._ref[pid]

    def generation(self, pid: int) -> int:
        return self._gen[pid]

    def alloc(self) -> Optional[int]:
        """Exclusively-owned fresh page, or None when exhausted."""
        if not self._free:
            self.metrics.alloc_failures += 1
            return None
        pid = self._free.pop()
        assert self._ref[pid] == 0
        self._ref[pid] = 1
        self._gen[pid] += 1
        self.metrics.allocs += 1
        self.metrics.peak_in_use = max(self.metrics.peak_in_use, self.in_use)
        return pid

    def alloc_n(self, n: int) -> Optional[List[int]]:
        """All-or-nothing batch allocation."""
        if n > len(self._free):
            self.metrics.alloc_failures += 1
            return None
        return [self.alloc() for _ in range(n)]

    def retain(self, pid: int) -> int:
        if self._ref[pid] <= 0:
            raise ValueError(f"retain of unreferenced page {pid}")
        self._ref[pid] += 1
        return pid

    def release(self, pid: int) -> None:
        if self._ref[pid] <= 0:
            raise ValueError(f"release of unreferenced page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
            self.metrics.frees += 1

    def writable(self, pid: int) -> Tuple[Optional[int], bool]:
        """Copy-on-write gate before mutating ``pid``.  Returns
        ``(page_to_write, copied)``: the same page when exclusively
        owned, otherwise a fresh page (caller must copy the bytes and
        swap its table entry; the original keeps its other holders).
        ``(None, False)`` when a copy is needed but the pool is dry."""
        if self._ref[pid] == 1:
            return pid, False
        fresh = self.alloc()
        if fresh is None:
            return None, False
        self.release(pid)
        self.metrics.cow_copies += 1
        return fresh, True

    def check_invariants(self) -> None:
        held = sum(1 for r in self._ref if r > 0)
        assert held + len(self._free) == self.num_pages, \
            (held, len(self._free), self.num_pages)
        assert all(r >= 0 for r in self._ref)
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate free entries"
        assert all(self._ref[p] == 0 for p in free_set), \
            "page simultaneously free and referenced"


@dataclasses.dataclass
class _PrefixEntry:
    pid: int
    covered: int        # tokens of the page actually filled (<= page_size)
    link: Tuple[int, int]   # (pid, generation) — this entry's chain id


class PrefixCache:
    """Content-addressed page chain for shared-prompt page reuse.

    A page's KV depends on the whole causal prefix, not just its own
    tokens, so entries are keyed ``(parent_link, page_tokens)``: the
    page's own token span plus the chain link of the page holding the
    preceding prefix (``None`` at the root).  A match therefore walks
    page-by-page, each hop O(page_size) to build and hash — O(T * P)
    per admission instead of hashing the full prefix per candidate.
    Links are ``(pid, allocation generation)``: a freed-and-reused page
    gets a new generation, so stale children of a dead chain can never
    resolve against the reincarnated page id.

    Entries hold one pool reference each; registered pages are
    therefore immutable for everyone but their original writer — any
    other holder goes through the pool's COW gate before writing.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: "OrderedDict[tuple, _PrefixEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def register(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Index a freshly prefilled prompt: every full page under its
        (parent, span) key, and the trailing partial page under every
        sub-length it holds (so a prompt diverging mid-page can still
        share the page up to the divergence point and COW from there)."""
        P = self.pool.page_size
        T = len(tokens)
        parent = None
        for i, pid in enumerate(pages):
            start = i * P
            if start >= T:
                break
            covered = min(P, T - start)
            span = tuple(tokens[start:start + covered])
            link = (pid, self.pool.generation(pid))
            if covered == P:
                # chain through the entry that actually owns this key —
                # first registrant wins, so children must hang off it
                parent = self._register_one((parent, span), pid, P,
                                            link).link
            else:
                for c in range(1, covered + 1):
                    self._register_one((parent, span[:c]), pid, c, link)
                break               # a partial page ends the chain

    def _register_one(self, key: tuple, pid: int, covered: int,
                      link: Tuple[int, int]) -> _PrefixEntry:
        e = self._entries.get(key)
        if e is not None:
            return e                # first registrant wins; bytes equal
        self.pool.retain(pid)
        e = _PrefixEntry(pid=pid, covered=covered, link=link)
        self._entries[key] = e
        return e

    def match(self, tokens: Sequence[int]
              ) -> Tuple[List[Tuple[int, int]], int]:
        """Longest shareable prefix of ``tokens``: a list of
        ``(page_id, covered)`` pairs (each RETAINED for the caller) and
        the total shared token count.  All pages but the last are full;
        a partial page ends the walk (the divergence page — the caller
        COWs it before writing its remaining slots)."""
        P = self.pool.page_size
        shared: List[Tuple[int, int]] = []
        parent = None
        pos = 0
        while pos < len(tokens):
            hit = None
            for c in range(min(P, len(tokens) - pos), 0, -1):
                key = (parent, tuple(tokens[pos:pos + c]))
                e = self._entries.get(key)
                if e is not None and e.covered == c:
                    hit, hit_key = e, key
                    break
            if hit is None:
                break
            self._entries.move_to_end(hit_key)
            self.pool.retain(hit.pid)
            self.pool.metrics.prefix_hits += 1
            shared.append((hit.pid, hit.covered))
            parent = hit.link
            pos += hit.covered
            if hit.covered < P:
                break                   # divergence inside this page
        return shared, pos

    def evict(self, want_pages: int = 1) -> int:
        """Drop LRU entries until ``want_pages`` pages returned to the
        free list (entries whose page has other holders free nothing but
        still leave the cache).  Returns pages actually freed."""
        freed = 0
        while self._entries and freed < want_pages:
            _, e = self._entries.popitem(last=False)
            before = self.pool.free_pages
            self.pool.release(e.pid)
            freed += self.pool.free_pages - before
            self.pool.metrics.prefix_evictions += 1
        return freed

    def drop_all(self) -> None:
        while self._entries:
            _, e = self._entries.popitem(last=False)
            self.pool.release(e.pid)
            self.pool.metrics.prefix_evictions += 1
