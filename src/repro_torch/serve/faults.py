"""Seeded, deterministic fault injection for the serving stack (mirrors
src/repro/serve/faults.py).

A :class:`FaultPlan` is a list of :class:`Fault` records the engine and
front end consult at **named injection sites**.  Every consultation is
counted, and a fault fires when its site matches and either its ``nth``
occurrence is reached or it is marked ``always`` — so a plan replays
identically run after run, and every recovery path can be held to a
result in tests: the same seeded plan gives the same quarantine set, the
same retry outcomes and the same restored tokens.  Randomness (which
slot, page and position a firing corrupts) comes from
``np.random.default_rng((seed, site index, consultation count))``, as in
the reference, so one plan and one seed pick the same targets in both
packages.

Sites (who consults, what the fault does):

``page_corrupt``   — engine, once per ``step()``: write the marker scale
                     byte SCALE_NAN into one live token's scale bytes of
                     the target request's pages (NaN into an fp pool);
                     the next window's poison scan catches it.
``swap_corrupt``   — ``HostSwapStore.put``, per swap-out (rid-matched):
                     corrupt the pinned host payload; the corruption is
                     caught after the restore, at the next decode window.
``prefill_nan``    — engine, per cold admission (rid-matched): poison the
                     prompt's freshly written pages with SCALE_NAN — the
                     footprint NaN activations leave through the
                     quantizer — and flag the slot.
``kernel_fail``    — the reference arms a one-shot Pallas launch failure
                     and degrades paged attention to its dense path.  The
                     port has no degraded path (a failed launch raises),
                     so its engine refuses a plan that holds this site.
``alloc_fail``     — ``BlockManager.ensure`` (through its fault hook), per
                     page grant: fail the grant; the engine recovers by
                     swapping the slot out (token-identical resume on
                     re-admission).
``stall``          — engine, once per ``step()``: wait ``stall_s`` seconds
                     (cooperatively — ``engine.abort_stall()`` breaks
                     out) before any work, a hung step loop for the
                     front end's watchdog to catch.

The corruption helpers write the layer-stacked pool leaves
``(L_g, P, page, n_kv, X)`` of every KV group in place (a leaf is found
by its plain name, ``layers.leaf_base``): the captured decode graph
reads those very tensors, so a rebound pool would serve the old pages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import SCALE_NAN
from repro_torch.models.layers import leaf_base

_SCALE_LEAVES = ("ks_pages", "vs_pages")
_FP_LEAVES = ("k_pages", "v_pages")


class FaultError(RuntimeError):
    """An injected failure (distinguishable from organic errors)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault: fire at the ``nth`` consultation of ``site``
    (counted per (site, rid) when ``rid`` targets a request, per site
    otherwise), or at every matching consultation when ``always``."""
    site: str
    nth: int = 0
    rid: Optional[int] = None
    always: bool = False
    stall_s: float = 0.25           # stall site only
    n_bytes: int = 4                # page_corrupt: scale bytes to hit

    def __post_init__(self):
        if self.site not in FaultPlan.SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"choose from {FaultPlan.SITES}")


class FaultPlan:
    """Deterministic plan: consultations are counted, firings recorded in
    ``fired`` as (site, rid, count), and any randomness derives from
    ``seed`` and the consultation count alone."""

    SITES = ("page_corrupt", "swap_corrupt", "prefill_nan",
             "kernel_fail", "alloc_fail", "stall")

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)
        self._counts = {}
        self.fired: List[Tuple[str, Optional[int], int]] = []

    def __repr__(self):
        return f"FaultPlan({self.faults!r}, seed={self.seed})"

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse ``--faults`` syntax: comma-separated sites with optional
        ``:key=value`` modifiers, e.g.
        ``"prefill_nan:rid=2,page_corrupt:nth=1,stall:stall_s=0.5,
        prefill_nan:rid=5:always"``."""
        faults = []
        for item in filter(None, (s.strip() for s in text.split(","))):
            site, *mods = item.split(":")
            kw = {}
            for m in mods:
                if m == "always":
                    kw["always"] = True
                    continue
                k, _, v = m.partition("=")
                if k in ("nth", "rid", "n_bytes"):
                    kw[k] = int(v)
                elif k == "stall_s":
                    kw[k] = float(v)
                else:
                    raise ValueError(f"bad fault modifier {m!r} in "
                                     f"{item!r}")
            faults.append(Fault(site=site, **kw))
        return cls(faults, seed=seed)

    def should_fire(self, site: str, rid: Optional[int] = None
                    ) -> Optional[Fault]:
        """Count one consultation of ``site`` (for ``rid``, when the site
        is request-scoped) and return the fault that fires now, if any."""
        if site not in self.SITES:
            raise ValueError(f"unknown fault site {site!r}")
        n_any = self._counts.get((site, None), 0)
        self._counts[(site, None)] = n_any + 1
        n_rid = 0
        if rid is not None:
            n_rid = self._counts.get((site, rid), 0)
            self._counts[(site, rid)] = n_rid + 1
        for f in self.faults:
            if f.site != site:
                continue
            # a fault's rid filters rid-scoped consultations; at a
            # site-wide consultation (rid=None) it is a target hint the
            # caller reads off the returned fault, not a mismatch
            if f.rid is not None and rid is not None and rid != f.rid:
                continue
            n = n_rid if (f.rid is not None and rid is not None) else n_any
            if f.always or n == f.nth:
                self.fired.append((site, rid, n))
                return f
        return None

    def rng(self, site: str) -> np.random.Generator:
        """Deterministic per-(site, consultation) generator."""
        n = self._counts.get((site, None), 0)
        return np.random.default_rng(
            (self.seed, self.SITES.index(site), n))


# =============================================================================
# Corruption helpers (the physical half of the injection sites)
# =============================================================================
def _page_index(pool, page_ids) -> torch.Tensor:
    return torch.as_tensor(np.asarray(page_ids, np.int64).reshape(-1),
                           device=next(iter(pool.values())).device)


def poison_pool_pages(pool, page_ids, offset: Optional[int] = None):
    """Write SCALE_NAN into every MX scale leaf (NaN into fp leaves) at
    the given physical pages — the whole page, or the one token
    ``offset`` of each — in every layer, in place; returns the pool."""
    ids = _page_index(pool, page_ids)
    for names, val in ((_SCALE_LEAVES, SCALE_NAN), (_FP_LEAVES, np.nan)):
        for name, leaf in pool.items():
            if leaf_base(name) not in names:
                continue
            if offset is None:
                leaf.index_fill_(1, ids, val)
            else:
                leaf[:, ids, offset] = val
    return pool


def scrub_pool_pages(pool, page_ids: Sequence[int]):
    """Zero every leaf's bytes at the given physical pages (in place;
    returns the pool).  A quarantined request's pages return to the free
    list still holding poison markers or NaN payloads; a later owner's
    attention reads the unwritten tail of a partly filled page masked,
    and a stale NaN survives the mask as ``0 * NaN``.  Scrubbing the dead
    pages before reuse restores the all-zeros state fresh pages were born
    with."""
    if len(page_ids) == 0:
        return pool
    ids = _page_index(pool, page_ids)
    for leaf in pool.values():
        leaf.index_fill_(1, ids, 0)
    return pool


def corrupt_swap_payload(pages) -> int:
    """Corrupt a ``swap.gather_pages`` host copy **in place**: every MX
    scale leaf is filled with SCALE_NAN (fp leaves with NaN), so the
    restored request is flagged by the first health scan after its
    restore.  Returns the number of leaves touched."""
    hit = 0
    for names, val in ((_SCALE_LEAVES, SCALE_NAN), (_FP_LEAVES, np.nan)):
        for name, leaf in pages.items():
            if leaf_base(name) in names:
                leaf.fill_(val)
                hit += 1
    return hit
