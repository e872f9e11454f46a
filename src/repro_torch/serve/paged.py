"""Paged KV-cache bookkeeping: page pool sizing, per-slot page tables, a
host-side page allocator with per-page refcounts, and the prefix-cache
index that lets requests share identical prompt blocks.  A copy of
``repro.serve.paged`` (pure numpy and hashlib), so the port imports
nothing of the JAX package.

FAMOUS banks its attention operands into fixed-size BRAM tiles so one
synthesis serves many shapes; the serving analogue is a *paged* KV cache:
every global-attention layer shares one pool of fixed-size pages
``(n_pages, page_size, kv_heads, head_dim)`` and each slot owns a list of
page ids (its *page table*) instead of a contiguous ``max_seq`` stripe.
HBM then scales with live tokens (``sum(ceil(len/page_size))`` pages), not
with ``n_slots x max_seq``, so a single long-context request can coexist
with many short ones in the same pool.

Prefix caching takes the reuse one rung further: the *contents* of a page
are a pure function of the token block it holds plus everything before it,
so identical prompt prefixes (shared system prompts, few-shot preambles)
can alias the same physical pages across slots.  The allocator keeps

  * a per-page **refcount** — a page may appear in several slots' tables;
    aliased pages are read-only by construction (the engine only ever maps
    *full* prompt blocks, and every write lands at positions past the
    mapped prefix, i.e. in the slot's private tail pages — copy-on-write
    degenerates to copy-never because the partial last block is always
    prefilled privately);
  * a **content-hash index** ``block hash -> page id`` over published
    pages (the engine publishes a request's full prompt blocks when it
    retires);
  * a **cached-free LRU**: pages whose refcount drops to 0 but that are
    still indexed.  They stay warm for future hits yet count as free
    capacity — allocation reclaims the oldest on demand (evicting its
    index entry), so a warm cache never blocks admission.

Allocator invariants (checked via :meth:`PageAllocator.assert_invariants`
by tests/test_torch_paged.py, which drives this allocator and the JAX
package's through one random sequence of operations):

  * page 0 is the *null page* — never handed out, it absorbs writes from
    inactive slots and padded prefill chunks; masked reads never see it.
  * every allocatable page is in exactly one of three states: on the free
    list, on the cached-free LRU (refcount 0, indexed), or live
    (refcount >= 1).
  * a page's refcount equals the number of slot tables holding it.
  * non-null writes only ever target pages with refcount 1 that sit past
    the slot's shared prefix (the engine's COW rule).
  * ``free(slot)`` drops one reference per held page and zeroes the table
    row; pages reaching refcount 0 return to the free list, or to the
    cached-free LRU if indexed.
  * allocation beyond capacity raises :class:`PagePoolExhausted` and
    leaves the allocator state untouched (clean admission control).

The allocator is deliberately host-side (numpy): page ids change at request
granularity, orders of magnitude slower than the decode step, and feeding
the jitted decode as a plain ``(n_slots, pages_per_slot)`` int32 operand
keeps one executable for every request mix (the paper's "reprogram the µB,
never re-synthesise").
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np

from repro_torch.obs.runtime import NULL_OBSERVER

NULL_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """Admission-control error: the page pool cannot back the request."""


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static geometry of the paged KV cache."""

    page_size: int = 16          # tokens per page (the banking granularity)
    n_pages: int = 0             # total pool pages incl. the null page

    def pages_per_slot(self, max_seq: int) -> int:
        return -(-max_seq // self.page_size)    # ceil

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @staticmethod
    def default_pool(n_slots: int, max_seq: int, page_size: int) -> int:
        """Pool sized to back a full batch of max-length sequences, plus the
        null page — the drop-in-capacity baseline.  Callers oversubscribe by
        passing a smaller ``n_pages`` explicitly."""
        return 1 + n_slots * (-(-max_seq // page_size))


def block_hashes(tokens, page_size: int) -> list:
    """Chained content hashes of the full ``page_size`` token blocks of
    ``tokens`` (the partial tail block is never hashed: it is never
    shareable).  Block j's hash covers blocks 0..j, so equal hashes imply
    equal *prefixes* — a page's K/V content is a pure function of its hash.
    """
    out = []
    digest = b""
    for j in range(len(tokens) // page_size):
        blk = np.asarray(tokens[j * page_size:(j + 1) * page_size],
                         np.int64).tobytes()
        digest = hashlib.blake2b(digest + blk, digest_size=16).digest()
        out.append(digest)
    return out


class PageAllocator:
    """Refcounting free-list allocator over page ids ``1..n_pages-1``
    (0 is null), with a prefix-cache index over published pages."""

    def __init__(self, cfg: PagedCacheConfig, n_slots: int, max_seq: int,
                 observer=None):
        assert cfg.n_pages >= 2, "pool needs the null page plus one real page"
        self.cfg = cfg
        # observability seam (repro.obs.runtime): page-op counters, pool
        # gauges, trace instants.  Host-pure — hooks take plain ints.
        self.obs = observer if observer is not None else NULL_OBSERVER
        self.n_slots = n_slots
        self.pages_per_slot = cfg.pages_per_slot(max_seq)
        self._free = list(range(cfg.n_pages - 1, 0, -1))  # pop() -> low ids
        # slot page tables; row s lists the pages of slot s, NULL_PAGE-padded.
        self.page_table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self._n_held = np.zeros((n_slots,), np.int32)
        # leading pages of each slot that are *shared* (refcount may be > 1;
        # read-only — all writes land past them)
        self._n_shared = np.zeros((n_slots,), np.int32)
        self._ref = np.zeros((cfg.n_pages,), np.int32)
        # prefix cache: block hash -> page id, inverse map, and the LRU of
        # refcount-0-but-still-indexed pages (reclaimed oldest-first)
        self._index: dict = {}
        self._page_hash: dict = {}
        self._lru: OrderedDict = OrderedDict()
        # bumped on every table mutation so callers can cache derived state
        # (e.g. the device copy of the page table) and re-upload only when
        # allocation actually changed
        self.version = 0

    # -- queries ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages allocatable right now: truly free plus cached-free (the
        LRU is reclaimed on demand, so a warm cache never blocks)."""
        return len(self._free) + len(self._lru)

    @property
    def cached_free_pages(self) -> int:
        return len(self._lru)

    def pages_held(self, slot: int) -> int:
        return int(self._n_held[slot])

    def pages_shared(self, slot: int) -> int:
        return int(self._n_shared[slot])

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def can_admit(self, n_tokens: int, hits=()) -> bool:
        """Would ``grow`` succeed for a fresh ``n_tokens`` admission whose
        leading blocks hit the cached pages ``hits``?  Cached-free hits are
        about to be pinned, so they cannot double as fresh capacity."""
        need = self.cfg.pages_for(max(n_tokens, 1)) - len(hits)
        avail = self.free_pages - sum(1 for p in hits if self._ref[p] == 0)
        return need <= avail

    # -- prefix cache --------------------------------------------------------
    def lookup(self, hashes) -> list:
        """Longest run of consecutive index hits from block 0 (a chained
        hash only makes sense as a prefix).  Returns the hit page ids."""
        pages = []
        for h in hashes:
            page = self._index.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def map_prefix(self, slot: int, pages) -> None:
        """Alias cached ``pages`` (from :meth:`lookup`) into the head of an
        empty slot's table, pinning each (refcount += 1; off the LRU)."""
        assert self._n_held[slot] == 0, (slot, self._n_held[slot])
        assert len(pages) <= self.pages_per_slot
        for j, page in enumerate(pages):
            self.page_table[slot, j] = page
            self._ref[page] += 1
            self._lru.pop(page, None)
        self._n_held[slot] = len(pages)
        self._n_shared[slot] = len(pages)
        self.version += 1

    def publish(self, slot: int, hashes) -> None:
        """Index the slot's leading pages under ``hashes`` (one per full
        prompt block) so future admissions can alias them.  Blocks whose
        hash is already indexed are skipped — the existing page wins (this
        slot's duplicate simply frees normally)."""
        n = min(len(hashes), int(self._n_held[slot]))
        row = self.page_table[slot, :n].tolist()   # one pull, not n
        published = 0
        for j in range(n):
            h = hashes[j]
            if h in self._index:
                continue
            page = row[j]
            self._index[h] = page
            self._page_hash[page] = h
            published += 1
        self.obs.on_page_event("publish", slot, published)

    def _take_page(self) -> int:
        """A fresh page: off the free list, else reclaim the LRU-oldest
        cached-free page (evicting its index entry)."""
        if self._free:
            return self._free.pop()
        page, _ = self._lru.popitem(last=False)
        del self._index[self._page_hash.pop(page)]
        self.obs.on_page_event("evict", -1, 1)
        return page

    # -- mutation -----------------------------------------------------------
    def grow(self, slot: int, n_tokens: int) -> None:
        """Ensure slot ``slot`` holds enough pages for ``n_tokens`` tokens.
        New pages are private (refcount 1).  Raises
        :class:`PagePoolExhausted` (state untouched) if it cannot."""
        need = self.cfg.pages_for(n_tokens)
        if need > self.pages_per_slot:
            raise PagePoolExhausted(
                f"{n_tokens} tokens need {need} pages, over the per-slot "
                f"cap of {self.pages_per_slot} (max_seq)")
        held = int(self._n_held[slot])
        short = need - held
        if short <= 0:
            return
        if short > self.free_pages:
            raise PagePoolExhausted(
                f"slot {slot} needs {short} more page(s) for {n_tokens} "
                f"tokens; {self.free_pages} free of "
                f"{self.cfg.n_pages - 1} allocatable")
        for j in range(held, need):
            page = self._take_page()
            self.page_table[slot, j] = page
            self._ref[page] = 1
        self._n_held[slot] = need
        self.version += 1
        self.obs.on_page_event("grow", slot, short)
        self.obs.on_pool(self.free_pages, len(self._lru))

    def shrink(self, slot: int, n_tokens: int) -> None:
        """Speculative rollback: drop the slot's tail pages beyond
        ``pages_for(n_tokens)``.  The engine grows a slot for its full
        draft before verifying; pages grown for *rejected* draft tokens
        come back here (no leak when a draft is cut at a page boundary).
        Never cuts into the shared prefix, and handles tail pages exactly
        like :meth:`free` (a just-reclaimed-from-LRU page is unindexed, so
        live private tails always return to the free list)."""
        keep = max(self.cfg.pages_for(max(n_tokens, 1)),
                   int(self._n_shared[slot]))
        held = int(self._n_held[slot])
        if held <= keep:
            return
        for page in self.page_table[slot, keep:held][::-1].tolist():
            self._ref[page] -= 1
            if self._ref[page] == 0:
                if page in self._page_hash:
                    self._lru[page] = None
                else:
                    self._free.append(page)
        self.page_table[slot, keep:held] = NULL_PAGE
        self._n_held[slot] = keep
        self.version += 1
        self.obs.on_page_event("shrink", slot, held - keep)
        self.obs.on_pool(self.free_pages, len(self._lru))

    def free(self, slot: int) -> None:
        """Retire a slot: drop one reference per held page and zero its
        table row.  Pages reaching refcount 0 return to the free list —
        or to the cached-free LRU if they are still indexed.  Deep blocks
        park *older* on the LRU than head blocks: a chained-prefix lookup
        stops at its first miss, so under reclaim pressure a prefix must
        be eaten from its deep end — evicting block 0 first would leave
        an unreachable suffix warm and the whole prefix cold."""
        held = int(self._n_held[slot])
        for page in self.page_table[slot, :held][::-1].tolist():  # one pull
            self._ref[page] -= 1
            if self._ref[page] == 0:
                if page in self._page_hash:
                    self._lru[page] = None       # most-recently-used end
                else:
                    self._free.append(page)
        self.page_table[slot, :] = NULL_PAGE
        self._n_held[slot] = 0
        self._n_shared[slot] = 0
        self.version += 1
        self.obs.on_page_event("free", slot, held)
        self.obs.on_pool(self.free_pages, len(self._lru))

    # -- debug --------------------------------------------------------------
    def assert_invariants(self) -> None:
        """Exhaustive state check (tests; O(pool), not for the hot loop)."""
        free, lru = set(self._free), set(self._lru)
        live = {p for p in range(1, self.cfg.n_pages) if self._ref[p] > 0}
        assert not (free & lru) and not (free & live) and not (lru & live), \
            (free & lru, free & live, lru & live)
        assert free | lru | live == set(range(1, self.cfg.n_pages))
        assert self._ref[NULL_PAGE] == 0
        counts = np.zeros_like(self._ref)
        for s in range(self.n_slots):
            held = int(self._n_held[s])
            assert 0 <= self._n_shared[s] <= held
            for page in self.page_table[s, :held].tolist():
                assert page != NULL_PAGE
                counts[page] += 1
            assert (self.page_table[s, held:] == NULL_PAGE).all()
        assert (counts == self._ref).all(), (counts, self._ref)
        for page in lru:
            assert page in self._page_hash
        for h, page in self._index.items():
            assert self._page_hash.get(page) == h
