"""The port's refcounted page allocator (``repro_torch.serve.paging``)
under the invariants of tests/test_paging_properties.py.

A seeded random interleaving of admissions, shared mappings,
copy-on-write forks, pins and releases must never violate the
BlockManager invariants its docstring promises:

* every non-trash page is on the free list xor has refcount > 0;
* per page, ``table_refs`` equals the number of block-table entries
  mapping it and ``pins`` the number of outstanding ``pin`` calls;
* ``free_pages + live_pages == num_pages - 1`` (page 0 is the trash page,
  never allocated, never pinned, never freed);
* ``version`` bumps exactly when ``tables`` mutates (allocate /
  map_shared / fork_page / release of a non-empty row) and never on
  pin/unpin.

``ModelChecker`` keeps an independent model of every slot row and pin
count and cross-checks the manager's public accounting after each
operation (the reference's checker, without swap-out, which the port
has not taken yet).  Error-path unit tests (fork of a private entry,
pin of a dead page, map of the trash page) close out the file.
"""
import collections

import numpy as np
import pytest

from repro_torch.serve.paging import TRASH_PAGE, BlockManager, pages_needed

NUM_PAGES = 12
PAGE = 4
MAX_SLOTS = 4
MAX_PPS = 6


class ModelChecker:
    """Independent model of the allocator: `rows` mirrors each slot's
    (page, shared) entries, `pins` the external pin counts, `version`
    the expected table-mutation counter.  Every op_* both applies the
    operation and asserts the manager agreed with the model about its
    outcome; `check()` asserts the global invariants."""

    def __init__(self):
        self.bm = BlockManager(NUM_PAGES, PAGE, MAX_SLOTS, MAX_PPS)
        self.rows = [[] for _ in range(MAX_SLOTS)]
        self.pins = collections.Counter()
        self.version = 0

    # -------------------------------------------------------- model views
    def table_refs(self):
        return collections.Counter(p for row in self.rows for p, _ in row)

    def refcounts(self):
        refs = self.table_refs()
        for p, c in self.pins.items():
            refs[p] += c
        return +refs

    def live_set(self):
        return set(self.refcounts())

    def shared_entries(self):
        return [(s, i) for s, row in enumerate(self.rows)
                for i, (_, sh) in enumerate(row) if sh]

    # -------------------------------------------------------- operations
    def op_allocate(self, slot, n):
        live_before = self.live_set()
        ok = self.bm.allocate(slot, n)
        assert ok == (len(self.rows[slot]) + n <= MAX_PPS
                      and n <= NUM_PAGES - 1 - len(live_before))
        if ok and n:
            self.version += 1
            fresh = self.bm.slot_page_ids(slot)[len(self.rows[slot]):]
            assert len(fresh) == n
            for pg in fresh:
                # freshly allocated pages must come off the free list
                assert pg != TRASH_PAGE and pg not in live_before
                self.rows[slot].append((pg, False))

    def op_map_shared(self, slot, pages):
        assert all(pg in self.live_set() for pg in pages)
        ok = self.bm.map_shared(slot, pages)
        assert ok == (len(self.rows[slot]) + len(pages) <= MAX_PPS)
        if ok and pages:
            self.version += 1
            self.rows[slot].extend((pg, True) for pg in pages)

    def op_fork_page(self, slot, idx):
        assert self.rows[slot][idx][1]
        live_before = self.live_set()
        pool_empty = self.bm.free_pages == 0
        got = self.bm.fork_page(slot, idx)
        if pool_empty:
            assert got is None           # exhausted pool: nothing changed
            return
        src, dst = got
        self.version += 1
        assert src == self.rows[slot][idx][0]
        assert dst != TRASH_PAGE and dst not in live_before
        self.rows[slot][idx] = (dst, False)

    def op_ensure(self, slot, tokens):
        need = pages_needed(tokens, PAGE) - len(self.rows[slot])
        live_before = self.live_set()
        ok = self.bm.ensure(slot, tokens)
        if need <= 0:
            assert ok                    # already covered: no-op
            return
        assert ok == (len(self.rows[slot]) + need <= MAX_PPS
                      and need <= NUM_PAGES - 1 - len(live_before))
        if ok:
            self.version += 1
            fresh = self.bm.slot_page_ids(slot)[len(self.rows[slot]):]
            for pg in fresh:
                assert pg not in live_before
                self.rows[slot].append((pg, False))

    def op_pin(self, pg):
        assert pg in self.live_set()
        v = self.bm.version
        self.bm.pin(pg)                  # never raises on a live page
        assert self.bm.version == v      # and never bumps version
        self.pins[pg] += 1

    def op_unpin(self, pg):
        assert self.pins[pg] > 0
        v = self.bm.version
        self.bm.unpin(pg)
        assert self.bm.version == v
        self.pins[pg] -= 1

    def op_release(self, slot):
        if self.rows[slot]:
            self.version += 1
        self.bm.release(slot)
        self.rows[slot] = []

    # -------------------------------------------------------- invariants
    def check(self):
        refs = self.refcounts()
        for pg in range(1, NUM_PAGES):
            assert self.bm.page_refcount(pg) == refs.get(pg, 0)
        live = self.live_set()
        assert self.bm.live_pages == len(live)
        assert self.bm.free_pages + self.bm.live_pages == NUM_PAGES - 1
        trefs = self.table_refs()
        assert self.bm.mapped_pages == len(trefs)
        assert self.bm.shared_pages == sum(
            1 for c in trefs.values() if c >= 2)
        assert self.bm.page_refcount(TRASH_PAGE) == 0
        assert self.bm.version == self.version
        for slot, row in enumerate(self.rows):
            ids = [p for p, _ in row]
            assert self.bm.slot_page_ids(slot) == ids
            assert self.bm.slot_pages(slot) == len(ids)
            assert self.bm.slot_capacity(slot) == len(ids) * PAGE
            assert list(self.bm.tables[slot, :len(ids)]) == ids
            # beyond the allocation the row points at the trash page
            assert (self.bm.tables[slot, len(ids):] == TRASH_PAGE).all()
            assert TRASH_PAGE not in ids
            shared_idx = [i for i, (_, sh) in enumerate(row) if sh]
            assert [i for i in range(len(ids))
                    if self.bm.is_shared_entry(slot, i)] == shared_idx
            assert self.bm.slot_shared_pages(slot) == len(shared_idx)
            assert self.bm.cow_targets(slot, 0, len(ids) * PAGE) \
                == shared_idx


# =============================================================================
# seeded random walk over the checker
# =============================================================================
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_walk_invariants(seed):
    rng = np.random.default_rng(seed)
    m = ModelChecker()
    for _ in range(300):
        op = rng.integers(0, 7)
        slot = int(rng.integers(0, MAX_SLOTS))
        if op == 0:
            m.op_allocate(slot, int(rng.integers(0, 5)))
        elif op == 1 and m.live_set():
            live = sorted(m.live_set())
            k = int(rng.integers(0, 4))
            m.op_map_shared(slot, [live[rng.integers(0, len(live))]
                                   for _ in range(k)])
        elif op == 2 and m.shared_entries():
            ents = m.shared_entries()
            m.op_fork_page(*ents[rng.integers(0, len(ents))])
        elif op == 3:
            m.op_ensure(slot, int(rng.integers(0, MAX_PPS * PAGE + 1)))
        elif op == 4 and m.live_set():
            live = sorted(m.live_set())
            m.op_pin(live[rng.integers(0, len(live))])
        elif op == 5 and +m.pins:
            pinned = sorted((+m.pins).keys())
            m.op_unpin(pinned[rng.integers(0, len(pinned))])
        elif op == 6:
            m.op_release(slot)
        m.check()


# =============================================================================
# error paths and edge semantics
# =============================================================================
def _bm(num_pages=8, page=4, slots=2, pps=4):
    return BlockManager(num_pages, page, slots, pps)


def test_map_shared_rejects_trash_and_dead_pages():
    bm = _bm()
    with pytest.raises(ValueError, match="trash"):
        bm.map_shared(0, [TRASH_PAGE])
    with pytest.raises(ValueError, match="dead"):
        bm.map_shared(0, [3])            # never allocated -> refcount 0
    assert bm.version == 0               # failed maps change nothing


def test_map_shared_row_overflow_maps_nothing():
    bm = _bm(pps=2)
    assert bm.allocate(0, 2)
    pg = bm.slot_page_ids(0)[0]
    assert not bm.map_shared(1, [pg, pg, pg])
    assert bm.slot_pages(1) == 0
    assert bm.page_refcount(pg) == 1     # no partial refcount leak


def test_fork_private_entry_raises():
    bm = _bm()
    assert bm.allocate(0, 1)
    with pytest.raises(ValueError, match="already private"):
        bm.fork_page(0, 0)


def test_fork_exhausted_pool_returns_none():
    bm = _bm(num_pages=3, pps=4)         # 2 usable pages
    assert bm.allocate(0, 2)
    src = bm.slot_page_ids(0)[0]
    assert bm.map_shared(1, [src])
    assert bm.fork_page(1, 0) is None    # nothing free to copy into
    assert bm.page_refcount(src) == 2    # shared mapping intact


def test_fork_frees_last_reference():
    bm = _bm()
    assert bm.allocate(0, 1)
    src = bm.slot_page_ids(0)[0]
    assert bm.map_shared(1, [src])
    bm.release(0)
    assert bm.page_refcount(src) == 1    # slot 1's shared mapping holds it
    free_before = bm.free_pages
    out = bm.fork_page(1, 0)
    assert out is not None and out[0] == src
    # the fork drops the last reference: src returns to the free list
    assert bm.free_pages == free_before  # -1 for dst, +1 for freed src
    assert bm.page_refcount(src) == 0


def test_pin_requires_live_page_and_survives_release():
    bm = _bm()
    with pytest.raises(ValueError, match="not pinnable"):
        bm.pin(TRASH_PAGE)
    with pytest.raises(ValueError, match="dead"):
        bm.pin(2)
    assert bm.allocate(0, 1)
    pg = bm.slot_page_ids(0)[0]
    v = bm.version
    bm.pin(pg)
    assert bm.version == v               # pin never bumps version
    bm.release(0)
    assert bm.page_refcount(pg) == 1     # pin outlives the slot
    bm.unpin(pg)
    assert bm.page_refcount(pg) == 0     # last unpin frees
    with pytest.raises(ValueError, match="no pins"):
        bm.unpin(pg)


def test_release_keeps_shared_pages_live():
    bm = _bm()
    assert bm.allocate(0, 2)
    ids = bm.slot_page_ids(0)
    assert bm.map_shared(1, ids)
    bm.release(0)
    assert all(bm.page_refcount(p) == 1 for p in ids)
    assert bm.slot_page_ids(1) == ids    # reader unaffected by the release
    bm.release(1)
    assert bm.free_pages == 7            # now everything is back
