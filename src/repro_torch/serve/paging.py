"""Host-side page accounting for the paged MX KV cache.

The device side is a page pool per attention layer (see
``models/layers.init_paged_kv_cache``): ``num_pages`` pages of ``page_size``
tokens of packed codes + E8M0 scales.  This module owns the free list and
the per-slot block tables that map a slot's logical token positions to
physical pages.

Physical page 0 is the **trash page**: it is never handed out, every idle
slot's block-table row points at it, and the decode step's unconditional
scatter for idle slots lands there — masked decode writes can never corrupt
a live request's pages.

Pages are **refcounted**: a physical page may be mapped read-only into
several slots' block tables at once (prefix sharing), and may also be
*pinned* by the prefix cache (``serve.prefix``) so it outlives the
request that computed it.  A page's refcount is the number of
block-table entries mapping it plus its pins; it returns to the free
list only when the refcount falls to zero.  Any write to a shared page
goes through ``fork_page`` (copy-on-write): the writer gets a fresh
private page and the shared original is decref'd, so no owner ever
observes another request's writes.  Preemption releases a slot through
``swap_out`` after the engine copied its pages to the host swap store
(``serve.swap``).  ``fault_hook`` (the fault plan's ``alloc_fail``
site) may fail a page grant of ``ensure``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

TRASH_PAGE = 0


class PageGrantError(RuntimeError):
    """A page grant failed for a slot whose capacity admission had
    reserved.  Carries the slot so the engine can recover by swapping that
    request out (it resumes token-identically on re-admission) instead of
    tearing the whole window down."""

    def __init__(self, slot: int, need: int):
        super().__init__(
            f"page grant failed for slot {slot} ({need} pages)")
        self.slot = slot
        self.need = need


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` positions (>= 1 so every admitted
    request owns the page its first generated token lands in)."""
    return max(1, -(-tokens // page_size))


class BlockManager:
    """Refcounted free-list allocator + block tables over a fixed page pool.

    ``tables`` is the host mirror of the device block-table operand: rows
    are zero (the trash page) beyond a slot's allocation, so the kernel's
    out-of-range page lookups always hit valid (masked) memory.

    ``version`` increments on every mutation of ``tables``; the serving
    engine keys its device-resident copy of the block table on it, so the
    host->device upload happens only when an admission, grant, fork or
    eviction actually changed the mapping — not on every decode window.

    A page's refcount decomposes as ``table_refs + pins``: ``table_refs``
    counts block-table entries (one per (slot, logical page) mapping),
    ``pins`` counts external holders (the prefix cache).  Invariants:

    * every non-trash page is on the free list xor has refcount > 0;
    * ``free_pages + live_pages == num_pages - 1`` (page 0 is the trash
      page, never allocated and never freed);
    * per page, ``table_refs`` equals the number of slot-table entries
      mapping it and ``pins`` the number of outstanding ``pin`` calls;
    * ``version`` bumps exactly when ``tables`` mutates (allocate /
      map_shared / fork_page / release of a non-empty row — never on
      pin/unpin, which touch no table).
    """

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_slot: int,
                 metrics: Optional[MetricsRegistry] = None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        # page-flow counters (pages.*) — a standalone manager gets its
        # own registry, the engine shares its registry in
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._c_alloc = self.metrics.counter(
            "pages.allocated", "fresh private pages granted")
        self._c_shared = self.metrics.counter(
            "pages.shared_mapped", "read-only prefix mappings added")
        self._c_forks = self.metrics.counter(
            "pages.cow_forks", "copy-on-write page forks")
        self._c_released = self.metrics.counter(
            "pages.released", "block-table entries released")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.version = 0
        # LIFO free list; page 0 reserved as trash
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self.tables = np.full((max_slots, max_pages_per_slot), TRASH_PAGE,
                              np.int32)
        self._owned: List[List[int]] = [[] for _ in range(max_slots)]
        # parallel to _owned: True where the entry was mapped read-only
        # from the prefix cache (a write there must fork_page first)
        self._shared: List[List[bool]] = [[] for _ in range(max_slots)]
        self._table_refs = np.zeros(num_pages, np.int32)
        self._pins = np.zeros(num_pages, np.int32)
        # fault-injection hook (serve.faults): called with the page count
        # of every non-trivial ensure(); returning True fails that grant
        self.fault_hook = None

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Distinct non-trash pages with refcount > 0."""
        return self.num_pages - 1 - len(self._free)

    @property
    def mapped_pages(self) -> int:
        """Distinct pages referenced by at least one slot's block table —
        the serving working set (prefix-cache pins excluded)."""
        return int(np.count_nonzero(self._table_refs[1:]))

    @property
    def shared_pages(self) -> int:
        """Distinct pages mapped by two or more block-table entries."""
        return int(np.count_nonzero(self._table_refs[1:] >= 2))

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def page_refcount(self, page: int) -> int:
        return int(self._table_refs[page] + self._pins[page])

    def slot_pages(self, slot: int) -> int:
        return len(self._owned[slot])

    def slot_shared_pages(self, slot: int) -> int:
        """Entries of ``slot``'s row still mapped read-only (not forked)."""
        return sum(self._shared[slot])

    def slot_page_ids(self, slot: int) -> List[int]:
        """The physical pages ``slot`` maps, in block-table order."""
        return list(self._owned[slot])

    def slot_capacity(self, slot: int) -> int:
        """Token positions the slot's current allocation can hold."""
        return len(self._owned[slot]) * self.page_size

    def is_shared_entry(self, slot: int, idx: int) -> bool:
        return self._shared[slot][idx]

    def cow_targets(self, slot: int, start: int, end: int) -> List[int]:
        """Logical page indices of ``slot`` that are mapped read-only and
        overlap token positions [start, end) — the pages a writer must
        ``fork_page`` before touching."""
        if end <= start:
            return []
        lo = start // self.page_size
        hi = (end - 1) // self.page_size
        flags = self._shared[slot]
        return [i for i in range(lo, min(hi, len(flags) - 1) + 1)
                if flags[i]]

    # ----------------------------------------------------------- mutations
    def _return_if_dead(self, page: int) -> None:
        if self._table_refs[page] == 0 and self._pins[page] == 0 \
                and page != TRASH_PAGE:
            self._free.append(page)

    def _map(self, slot: int, page: int, shared: bool) -> None:
        owned = self._owned[slot]
        self.tables[slot, len(owned)] = page
        owned.append(page)
        self._shared[slot].append(shared)
        self._table_refs[page] += 1

    def allocate(self, slot: int, n: int) -> bool:
        """Append ``n`` fresh private pages to ``slot``'s block-table row.
        Returns False (allocating nothing) if the pool or the row can't
        hold them."""
        if not self.can_allocate(n) \
                or len(self._owned[slot]) + n > self.max_pages_per_slot:
            return False
        if n:
            self.version += 1
            self._c_alloc.inc(n)
        for _ in range(n):
            self._map(slot, self._free.pop(), False)
        return True

    def map_shared(self, slot: int, pages: Sequence[int]) -> bool:
        """Append live ``pages`` read-only to ``slot``'s row (refcount++
        each) — prefix-cache admission.  The pages stay owned by whoever
        else maps or pins them; this slot must ``fork_page`` before any
        write.  Returns False (mapping nothing) if the row can't hold
        them; raises if a page is dead or the trash page (a scheduler bug
        — shared mappings must come from live cache entries)."""
        if len(self._owned[slot]) + len(pages) > self.max_pages_per_slot:
            return False
        if not pages:
            return True
        for pg in pages:
            if pg == TRASH_PAGE or self.page_refcount(pg) == 0:
                raise ValueError(
                    f"map_shared: page {pg} is "
                    f"{'the trash page' if pg == TRASH_PAGE else 'dead'}")
        self.version += 1
        self._c_shared.inc(len(pages))
        for pg in pages:
            self._map(slot, int(pg), True)
        return True

    def fork_page(self, slot: int, idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: replace ``slot``'s read-only entry ``idx`` with a
        fresh private page.  Returns ``(src, dst)`` physical ids — the
        caller must copy the device page contents src -> dst before
        writing — or None when the pool is exhausted.  The shared original
        is decref'd (and freed if this was its last reference)."""
        if not self._shared[slot][idx]:
            raise ValueError(f"fork_page: slot {slot} entry {idx} is "
                             f"already private")
        if not self._free:
            return None
        src = self._owned[slot][idx]
        dst = self._free.pop()
        self.version += 1
        self._c_forks.inc()
        self.tables[slot, idx] = dst
        self._owned[slot][idx] = dst
        self._shared[slot][idx] = False
        self._table_refs[dst] += 1
        self._table_refs[src] -= 1
        self._return_if_dead(src)
        return src, dst

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s allocation to cover ``tokens`` positions."""
        need = pages_needed(tokens, self.page_size) - self.slot_pages(slot)
        if need <= 0:
            return True
        if self.fault_hook is not None and self.fault_hook(need):
            return False
        return self.allocate(slot, need)

    def pin(self, page: int) -> None:
        """External (prefix-cache) reference: the page survives ``release``
        of every slot mapping it until ``unpin``.  Never touches tables,
        so ``version`` is unchanged."""
        if page == TRASH_PAGE:
            raise ValueError("pin: the trash page is not pinnable")
        if self.page_refcount(page) == 0:
            raise ValueError(f"pin: page {page} is dead (pin must happen "
                             f"while an owner still maps it)")
        self._pins[page] += 1

    def unpin(self, page: int) -> None:
        if self._pins[page] <= 0:
            raise ValueError(f"unpin: page {page} has no pins")
        self._pins[page] -= 1
        self._return_if_dead(page)

    def swap_out(self, slot: int) -> List[Tuple[int, bool]]:
        """Snapshot-and-release for preemption: returns ``slot``'s
        ``(physical page, was_shared)`` entries in logical order, then
        releases the row exactly like :meth:`release`.  The caller must
        have copied the pages' contents to the swap store *before* this
        call: afterwards the pages nobody else maps or pins are back on
        the free list and may be rewritten at any time; pinned and shared
        pages stay live."""
        row = list(zip(self._owned[slot],
                       (bool(x) for x in self._shared[slot])))
        self.release(slot)
        return row

    def release(self, slot: int) -> None:
        """Decref all of ``slot``'s pages and re-point its row at trash.
        Pages still mapped by other slots or pinned by the prefix cache
        stay live; the rest return to the free list."""
        if self._owned[slot]:
            self.version += 1
            self._c_released.inc(len(self._owned[slot]))
        for pg in reversed(self._owned[slot]):
            self._table_refs[pg] -= 1
            self._return_if_dead(pg)
        self._owned[slot] = []
        self._shared[slot] = []
        self.tables[slot, :] = TRASH_PAGE
