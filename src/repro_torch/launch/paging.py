"""Host-side page bookkeeping for the paged KV arena: port of
`repro.launch.paging` (numpy only, as there).

The device side is a pool: each attention layer's K/V leaves are
`(n_blocks, n_pages, page_size, KVh, dh)` tensors shared by every slot,
addressed through per-slot page tables (logical page -> physical page).
Everything that decides which physical page backs which logical row lives
here, on the host, where admission and eviction already run:

- `PageAllocator`: free-list allocation with refcounts and an explicit
  dirty -> zeroed -> free lifecycle. A released page (refcount hit 0) is
  quarantined as dirty until the engine has zeroed it on the device
  (`take_dirty` / `mark_zeroed`); `alloc` only ever hands out zeroed
  pages, so rows beyond a slot's written prefix are zero by construction.

- `PrefixCache`: refcounted whole-prompt sharing keyed on a hash of the
  prompt tokens. A hit retains the entry's full prompt pages (N slots with
  the same prompt pin one copy of its K/V), reuses the memoized first
  token and skips the prefill; the partial tail page, which the owner's
  decode writes into, is copy-on-write: the entry keeps a pristine
  template and every sharer copies it into a freshly allocated page.

  Sharing is whole-prompt on purpose: the K/V rows of a shared prefix
  need not be bitwise equal across prefills of different total lengths
  (the reductions may group differently with the sequence length), so
  partial sharing could break the paged-vs-contiguous token identity.
  Whole-prompt reuse is exact: the contiguous engine computes a repeated
  prompt's prefill by the same call on the same inputs, hence the same
  bits the cached pages hold.

Two physical pages are reserved: page 0 is the permanent ZERO page (it
backs every unallocated logical page, so gathered views of a slot's
unwritten tail are zero) and page 1 is the TRASH page (idle slots' decode
writes land there: the engine decodes every slot every step, and an idle
slot must not be able to write into page 0).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np

ZERO_PAGE = 0
TRASH_PAGE = 1
N_RESERVED = 2


def pages_for_rows(n_rows: int, page_size: int) -> int:
    """Logical pages covering `n_rows` arena rows."""
    return -(-int(n_rows) // int(page_size))


class PageAllocator:
    """Free-list page allocator with refcounts and zero-before-reuse.

    Page lifecycle: free -> live (refcount >= 1, via `alloc`/`retain`)
    -> dirty (refcount hit 0 in `release`) -> free again only after the
    caller zeroed it on device and called `mark_zeroed`. `alloc` draws
    exclusively from the free list, so a page can never be handed out
    while another owner holds it (no double allocation) nor before its
    stale contents were zeroed — the two invariants the property tests
    drive with random admit/evict/rollback interleavings.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= N_RESERVED:
            raise ValueError(f"need > {N_RESERVED} pages (zero + trash are "
                             f"reserved), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(self.n_pages, np.int64)
        self.refcount[:N_RESERVED] = 1          # permanently held
        # pop() from the tail -> lowest ids first (stable, test-friendly)
        self._free = list(range(self.n_pages - 1, N_RESERVED - 1, -1))
        self._dirty: list[int] = []

    # ------------------------------------------------------------ queries
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Pages some owner (slot or prefix-cache entry) currently pins."""
        return (self.n_pages - N_RESERVED - len(self._free)
                - len(self._dirty))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    # ---------------------------------------------------------- lifecycle
    def alloc(self, n: int) -> list[int]:
        """Take n zeroed pages (refcount 1 each). Raises if the free list
        cannot cover the request — callers relieve pressure first
        (`PrefixCache.drop_lru`) and re-check with `can_alloc`."""
        if n > len(self._free):
            raise MemoryError(
                f"paged KV arena exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.n_pages} "
                f"({len(self._dirty)} dirty, {self.n_live} live)")
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] += 1
        return pages

    def retain(self, pages) -> None:
        """Add one owner to already-live pages (prefix-sharing fan-out)."""
        pages = [int(p) for p in pages]
        if any(p < N_RESERVED for p in pages) or np.any(
                self.refcount[pages] < 1):
            raise ValueError(f"retain of reserved/non-live page(s) {pages}")
        self.refcount[pages] += 1

    def release(self, pages) -> list[int]:
        """Drop one owner per page; pages whose refcount hits 0 move to
        the dirty quarantine and are returned (the caller must zero them
        on device and `mark_zeroed` before they become allocatable)."""
        freed = []
        for p in pages:
            p = int(p)
            if p < N_RESERVED or self.refcount[p] < 1:
                raise ValueError(f"release of non-live page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._dirty.append(p)
                freed.append(p)
        return freed

    def take_dirty(self) -> list[int]:
        """Hand the dirty quarantine to the caller for device zeroing."""
        dirty, self._dirty = self._dirty, []
        return dirty

    def mark_zeroed(self, pages) -> None:
        """Return zeroed pages to the free list."""
        for p in pages:
            p = int(p)
            if self.refcount[p] != 0 or p in self._free or p in self._dirty:
                raise ValueError(f"mark_zeroed of non-quarantined page {p}")
            self._free.append(p)

    def check(self) -> None:
        """Assert the partition invariant: every page is in exactly one
        of {reserved, free, dirty, live}."""
        free, dirty = set(self._free), set(self._dirty)
        assert not free & dirty, free & dirty
        for p in range(self.n_pages):
            states = ((p < N_RESERVED) + (p in free) + (p in dirty)
                      + (p >= N_RESERVED and self.refcount[p] > 0))
            assert states == 1, (p, self.refcount[p], p in free, p in dirty)


def prompt_key(prompt: np.ndarray) -> bytes:
    """Content hash of a prompt token stream (whole-prompt sharing key)."""
    a = np.ascontiguousarray(np.asarray(prompt, np.int32))
    return hashlib.sha1(a.tobytes()).digest() + len(a).to_bytes(4, "little")


@dataclasses.dataclass
class PrefixEntry:
    key: bytes
    prompt_len: int
    full_pages: tuple[int, ...]     # pages fully covered by prompt rows
    tail_page: Optional[int]        # pristine CoW template (partial page)
    first_token: int                # memoized prefill argmax

    @property
    def pages(self) -> list[int]:
        return list(self.full_pages) + (
            [self.tail_page] if self.tail_page is not None else [])


class PrefixCache:
    """LRU cache of whole-prompt KV page sets (see module docstring).

    Each entry holds one allocator reference on its pages, so a hot
    prompt's K/V survives every individual owner's eviction — exactly
    the "refcounted shared-prefix pages survive one owner's eviction"
    property — until capacity or allocator pressure drops the entry.
    """

    def __init__(self, alloc: PageAllocator, capacity: int = 8):
        self.alloc = alloc
        self.capacity = int(capacity)
        self._entries: OrderedDict[bytes, PrefixEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray) -> Optional[PrefixEntry]:
        ent = self._entries.get(prompt_key(prompt))
        if ent is None:
            self.misses += 1
            return None
        self._entries.move_to_end(prompt_key(prompt))
        self.hits += 1
        return ent

    def insert(self, ent: PrefixEntry) -> None:
        """Register an entry; its pages must already carry this cache's
        +1 refcount (the engine retains/allocates before registering)."""
        if ent.key in self._entries:
            raise ValueError("duplicate prefix entry")
        self._entries[ent.key] = ent
        while len(self._entries) > self.capacity:
            self.drop_lru()

    def drop_lru(self) -> list[int]:
        """Release the least-recently-used entry's hold. Returns the
        pages freed to dirty (possibly none, if slots still share them)."""
        if not self._entries:
            return []
        _, ent = self._entries.popitem(last=False)
        return self.alloc.release(ent.pages)

    def drop_all(self) -> list[int]:
        freed = []
        while self._entries:
            freed += self.drop_lru()
        return freed
