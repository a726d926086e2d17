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

Every page has exactly one owner (the slot whose row maps it); prefix
sharing, which needs refcounted pages, is left to the slice that ports the
prefix cache.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

TRASH_PAGE = 0


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` positions (>= 1 so every admitted
    request owns the page its first generated token lands in)."""
    return max(1, -(-tokens // page_size))


class BlockManager:
    """Free-list allocator + block tables over a fixed page pool.

    ``tables`` is the host mirror of the device block-table operand: rows
    are zero (the trash page) beyond a slot's allocation, so the kernel's
    out-of-range page lookups always hit valid (masked) memory.

    ``version`` increments on every mutation of ``tables``; the serving
    engine keys its device-resident copy of the block table on it, so the
    host->device upload happens only when an admission/grant/eviction
    actually changed the mapping — not on every decode window.

    Invariants: every non-trash page is on the free list xor in exactly
    one slot's row, so ``free_pages + live_pages == num_pages - 1`` (page 0
    is never allocated and never freed).
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
            "pages.allocated", "fresh pages granted")
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

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Non-trash pages held by some slot."""
        return self.num_pages - 1 - len(self._free)

    def slot_pages(self, slot: int) -> int:
        return len(self._owned[slot])

    def slot_capacity(self, slot: int) -> int:
        """Token positions the slot's current allocation can hold."""
        return len(self._owned[slot]) * self.page_size

    # ----------------------------------------------------------- mutations
    def allocate(self, slot: int, n: int) -> bool:
        """Append ``n`` fresh pages to ``slot``'s block-table row.
        Returns False (allocating nothing) if the pool or the row can't
        hold them."""
        owned = self._owned[slot]
        if n > len(self._free) or len(owned) + n > self.max_pages_per_slot:
            return False
        if n:
            self.version += 1
            self._c_alloc.inc(n)
        for _ in range(n):
            pg = self._free.pop()
            self.tables[slot, len(owned)] = pg
            owned.append(pg)
        return True

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s allocation to cover ``tokens`` positions."""
        need = pages_needed(tokens, self.page_size) - self.slot_pages(slot)
        return need <= 0 or self.allocate(slot, need)

    def release(self, slot: int) -> None:
        """Return all of ``slot``'s pages to the free list and re-point its
        row at trash."""
        if self._owned[slot]:
            self.version += 1
            self._c_released.inc(len(self._owned[slot]))
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self.tables[slot, :] = TRASH_PAGE
