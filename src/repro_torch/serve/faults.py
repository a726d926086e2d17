"""Quarantine hygiene for the page pool (the one function of
src/repro/serve/faults.py that the serving path needs; fault injection
is left to the slice that ports it)."""
from __future__ import annotations

from typing import Sequence

import torch


def scrub_pool_pages(pool, page_ids: Sequence[int]):
    """Zero every leaf's bytes at the given physical pages (in place;
    returns the pool).  A quarantined request's pages return to the free
    list still holding poison markers or NaN payloads; a later owner's
    attention reads the unwritten tail of a partly filled page masked,
    and a stale NaN survives the mask as ``0 * NaN``.  Scrubbing the dead
    pages before reuse restores the all-zeros state fresh pages were born
    with.  Leaves are layer-stacked: (L, P, page, n_kv, X)."""
    ids = list(page_ids)
    if not ids:
        return pool
    idx = torch.tensor(ids, dtype=torch.int64,
                       device=next(iter(pool.values())).device)
    for leaf in pool.values():
        leaf.index_fill_(1, idx, 0)
    return pool
