"""Prefix cache: a trie over full KV pages keyed by page token content
(the port's own copy of src/repro/serve/prefix.py).

Each trie node represents one *full* page of ``page_size`` tokens and is
keyed by that page's token tuple **under its parent chain** — so a node's
path from the root spells out the entire token prefix, and two pages with
identical local tokens but different histories never collide (causal
attention makes a page's KV a function of every token before it, so
content-addressing must hash the whole chain, not the page alone).

A node holds the physical page id of the canonical KV copy and ``pin``s it
in the :class:`~repro_torch.serve.paging.BlockManager`, so the page outlives the
request that computed it.  Admission walks the trie with the new prompt's
page tuples; the longest matched chain's pages are mapped read-only into
the new slot (``map_shared``) and only the uncached suffix is prefilled.

Insertion dedupes: walking an existing node keeps the canonical page and
ignores the caller's duplicate (whose refcount simply drops when its slot
releases).  Under MX quantization the dedupe is exact — a page's quantized
bytes are a deterministic function of the token prefix, so the canonical
copy is bit-identical to the duplicate it shadows.

``reclaim(n)`` unpins least-recently-used *leaves* until ``n`` pages have
actually returned to the free list (an unpinned page still mapped by a
running slot frees nothing yet) — the scheduler calls it when pinned pages
would otherwise starve admission.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.paging import BlockManager


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_use = 0


class PrefixCache:
    """Trie of pinned full KV pages over ``blocks``.

    ``max_pages`` caps how many pages the trie may pin (None = unbounded
    up to the pool); insertion past the cap reclaims LRU leaves first and
    skips the insert if nothing can be evicted.
    """

    def __init__(self, blocks: BlockManager,
                 max_pages: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.blocks = blocks
        self.page_size = blocks.page_size
        self.max_pages = max_pages
        self._root = _Node((), -1, None)
        self._n_nodes = 0
        self._tick = 0
        # admission stats (recorded once per admitted request, not per
        # speculative lookup — see Scheduler.admit); registry-backed so
        # a registry reset or snapshot sees them with everything else
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._c_lookups = self.metrics.counter(
            "prefix.lookups", "admissions probing the trie")
        self._c_hits = self.metrics.counter(
            "prefix.hits", "admissions matching a non-empty prefix")
        self._c_tokens = self.metrics.counter(
            "prefix.tokens_matched", "prompt tokens served from cache")

    # registry-backed stat views (setters: snapshot restore rewinds them)
    @property
    def lookups(self) -> int:
        return int(self._c_lookups.value())

    @lookups.setter
    def lookups(self, v: int) -> None:
        self._c_lookups.set(int(v))

    @property
    def hits(self) -> int:
        return int(self._c_hits.value())

    @hits.setter
    def hits(self, v: int) -> None:
        self._c_hits.set(int(v))

    @property
    def tokens_matched(self) -> int:
        return int(self._c_tokens.value())

    @tokens_matched.setter
    def tokens_matched(self, v: int) -> None:
        self._c_tokens.set(int(v))

    # ------------------------------------------------------------- queries
    @property
    def pinned_pages(self) -> int:
        return self._n_nodes

    def _keys(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        return [tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
                for i in range(len(toks) // ps)]

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached full-page prefix of ``tokens``.

        Returns ``(pages, matched_tokens)`` — the canonical physical page
        ids of the matched chain (all pinned, hence live) and the token
        count they cover (a page-size multiple).  Touches the chain's LRU
        clocks; stats are recorded separately (``record``) so speculative
        re-lookups of a still-waiting request don't skew the hit rate."""
        self._tick += 1
        node = self._root
        pages: List[int] = []
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._tick
            pages.append(child.page)
            node = child
        return pages, len(pages) * self.page_size

    def record(self, matched_tokens: int) -> None:
        """Count one admission against the hit-rate stats."""
        self._c_lookups.inc()
        if matched_tokens > 0:
            self._c_hits.inc()
            self._c_tokens.inc(matched_tokens)

    # ----------------------------------------------------------- mutation
    def insert(self, tokens: Sequence[int], page_ids: Sequence[int]) -> int:
        """Insert the full pages of ``tokens``, whose KV lives in
        ``page_ids`` (one physical id per full page, trash-free, currently
        mapped by the caller's slot).  Existing nodes dedupe — the caller's
        duplicate page is not pinned; new nodes pin the caller's page.
        Returns the number of pages newly pinned."""
        self._tick += 1
        keys = self._keys(tokens)
        node = self._root
        added = 0
        for key, pg in zip(keys, page_ids):
            child = node.children.get(key)
            if child is None:
                if self.max_pages is not None \
                        and self._n_nodes >= self.max_pages \
                        and self.reclaim_nodes(1) == 0:
                    break
                self.blocks.pin(int(pg))
                child = _Node(key, int(pg), node)
                node.children[key] = child
                self._n_nodes += 1
                added += 1
            child.last_use = self._tick
            node = child
        return added

    def _leaves(self) -> List[_Node]:
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _drop(self, node: _Node) -> None:
        del node.parent.children[node.key]
        self._n_nodes -= 1
        self.blocks.unpin(node.page)

    def reclaim_nodes(self, n: int) -> int:
        """Unpin up to ``n`` LRU leaf nodes; returns how many were
        dropped (regardless of whether their pages freed)."""
        dropped = 0
        while dropped < n:
            leaves = self._leaves()
            if not leaves:
                break
            self._drop(min(leaves, key=lambda nd: nd.last_use))
            dropped += 1
        return dropped

    def reclaim(self, n_pages: int) -> int:
        """Drop LRU leaves until ``n_pages`` pages have actually returned
        to the free list, or the trie is empty.  Returns pages freed."""
        freed = 0
        while freed < n_pages:
            leaves = self._leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_use)
            before = self.blocks.free_pages
            self._drop(victim)
            freed += self.blocks.free_pages - before
        return freed
