"""Slot-based continuous-batching scheduler with FIFO admission.

Requests arrive with arbitrary prompt lengths and generation budgets; the
scheduler admits them into a fixed number of decode slots as slots and KV
pages free up, and evicts them on completion.  Admission is conservative:
a request is only admitted when the pool can hold its whole sequence
(prompt + max_new_tokens), so an in-flight request can never stall on
page exhaustion.

With a :class:`~repro_torch.serve.prefix.PrefixCache` installed,
admission maps the longest cached full-page prefix of each prompt
read-only into the new slot and charges only the private remainder
against the pool (:meth:`Scheduler.admit`).

A request whose numeric-health guard trips is quarantined
(:meth:`Scheduler.fail`): its slot and pages free as on eviction, and it
is parked on ``failed`` with a diagnostic.  SLO classes, preempt-and-swap
and retries are left to the slices that port them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models.decoder import mix32
from repro_torch.serve.paging import BlockManager, pages_needed
from repro_torch.serve.prefix import PrefixCache


def request_seed(seed: int, rid: int) -> int:
    """The 32-bit PRNG stream of request ``rid`` under the engine's
    ``seed`` (the reference folds the rid into the engine key).  A slot's
    sampling keys start from it (``decoder.request_keys``) and advance
    with the request's own steps only, so its tokens depend on (seed,
    rid, step) alone: not on the batch, the slot or the decode window,
    and a replay under the same rid is token-identical."""
    lane = 0xFFFFFFFF
    return mix32(mix32((seed ^ 0x9E3779B9) & lane) ^ (rid & lane))


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"           # quarantined by a numeric-health guard


@dataclasses.dataclass
class Request:
    """One generation request's lifecycle through the engine."""
    rid: int
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int
    state: RequestState = RequestState.WAITING
    slot: int = -1
    out: List[int] = dataclasses.field(default_factory=list)
    # prefix-cache admission outcome (0 with sharing off or on a miss):
    # tokens covered by pages mapped read-only from the prefix trie, and
    # the copy-on-write forks the engine still owes before prefill (a
    # fully cached prompt forks its last page to rewrite position L-1)
    matched_tokens: int = 0
    cow_pending: int = 0
    error: Optional[str] = None         # quarantine diagnostic (FAILED)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_start(self) -> int:
        """First prompt position the engine must compute: the matched
        prefix is skipped, but the last prompt position is always
        recomputed — its logits seed the first generated token."""
        return min(self.matched_tokens, self.prompt_len - 1)

    @property
    def total_len(self) -> int:
        """Upper bound on cache positions the request can occupy."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens

    @property
    def remaining(self) -> int:
        """Tokens the request is still entitled to generate."""
        return self.max_new_tokens - len(self.out)


class Scheduler:
    """FIFO admission into ``max_slots`` decode slots backed by
    ``blocks``, sharing cached prefixes through ``prefix`` when given."""

    def __init__(self, max_slots: int, blocks: BlockManager,
                 prefix: Optional[PrefixCache] = None):
        self.max_slots = max_slots
        self.blocks = blocks
        self.prefix = prefix
        self.waiting: List[Request] = []        # arrival order
        self.running: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []
        self.failed: List[Request] = []         # quarantined
        self._free_slots = list(range(max_slots - 1, -1, -1))

    # ------------------------------------------------------------- queries
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ----------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        need = pages_needed(req.total_len, self.blocks.page_size)
        if need > self.blocks.max_pages_per_slot \
                or need > self.blocks.num_pages - 1:
            raise ValueError(
                f"request {req.rid}: {req.total_len} tokens ({need} pages) "
                f"can never fit a slot "
                f"({self.blocks.max_pages_per_slot} pages) or the pool "
                f"({self.blocks.num_pages - 1} usable pages)")
        self.waiting.append(req)

    def _outstanding_pages(self) -> int:
        """*Fresh* pages the running set is still entitled to consume.
        Admission must leave these uncommitted or a running slot could
        stall on page exhaustion mid-generation.  ``slot_pages`` includes
        pages mapped read-only from the prefix cache, which cost the pool
        nothing, so the difference is exactly the private growth — plus
        any copy-on-write fork the engine still owes (a fork takes one
        fresh page while the shared original lives on)."""
        return sum(
            pages_needed(r.total_len, self.blocks.page_size)
            - self.blocks.slot_pages(r.slot) + r.cow_pending
            for r in self.running.values())

    def admit(self) -> List[Request]:
        """Admit waiting requests in arrival order — no head-of-line
        bypass — while a slot is free and the pool can hold their full
        sequence on top of what the running set is already entitled to.

        With a prefix cache, the longest cached full-page prefix of each
        prompt is mapped read-only into the new slot (refcount++, no
        fresh pages) and only the *private* remainder — uncached prompt
        pages, decode growth, and the copy-on-write fork of a fully
        cached prompt's last page — is charged against the free pool.
        When pinned-but-unmapped trie pages are all that stand between a
        request and admission, the trie reclaims them LRU-first; if the
        request still does not fit, the tentative mapping is backed out
        and it waits.  Each admitted slot is granted its prompt's private
        pages."""
        admitted = []
        ps = self.blocks.page_size
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            pages: List[int] = []
            matched = 0
            if self.prefix is not None:
                pages, matched = self.prefix.lookup(req.prompt)
            cow = 1 if matched and matched >= req.prompt_len else 0
            need_private = pages_needed(req.total_len, ps) - len(pages) \
                + cow
            # map the match before any reclaim: table refs keep the
            # matched chain from being recycled by its own unpinning
            slot = self._free_slots[-1]
            if pages:
                ok = self.blocks.map_shared(slot, pages)
                assert ok, "submit() bounded the row; a full-page match " \
                    "of the prompt always fits it"
            avail = self.blocks.free_pages - self._outstanding_pages()
            if need_private > avail and self.prefix is not None:
                avail += self.prefix.reclaim(need_private - avail)
            if need_private > avail:
                self.blocks.release(slot)   # undo the tentative mapping
                break                       # FIFO: wait
            self._free_slots.pop()
            priv = pages_needed(req.prompt_len, ps) - len(pages)
            if priv > 0:
                ok = self.blocks.allocate(slot, priv)
                assert ok
            req.slot = slot
            req.matched_tokens = matched
            req.cow_pending = cow
            req.state = RequestState.RUNNING
            self.running[slot] = req
            self.waiting.pop(0)
            admitted.append(req)
            if self.prefix is not None:
                self.prefix.record(matched)
        return admitted

    # ------------------------------------------------- decode-window planning
    def plan_window(self, lengths, sync_every: int) -> int:
        """Plan the next device-resident decode window.

        Returns the number of decode steps to run — ``sync_every`` capped
        by the longest remaining generation budget (so a window is never
        all dead steps), rounded up to a power of two as the reference
        does — and pre-grants every running slot the pages its window
        writes need, clamped to the request's reserved full-sequence
        capacity.  Because admission reserved that capacity, the grants
        cannot fail, and the window runs to its end without returning to
        the host for a page grant.  Slots whose budget runs out inside the
        window are masked on device (their writes land on the trash page)
        and recycled at the next sync point.
        """
        if not self.running:
            return 0
        need = max(r.remaining for r in self.running.values())
        window = min(max(1, int(sync_every)),
                     1 << (need - 1).bit_length())
        for slot, req in self.running.items():
            tgt = min(int(lengths[slot]) + window + 1, req.total_len)
            ok = self.blocks.ensure(slot, tgt)
            assert ok, "admission reserved the full sequence's pages"
            assert self.blocks.slot_capacity(slot) - int(lengths[slot]) \
                >= min(window, req.remaining), "page grant below horizon"
        return window

    def evict(self, req: Request) -> None:
        """Release a finished request's slot and return its pages to the
        free list."""
        req.state = RequestState.FINISHED
        self.blocks.release(req.slot)
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        self.finished.append(req)

    def fail(self, req: Request, error: str) -> None:
        """Quarantine a running request: free its slot and pages exactly
        like :meth:`evict`, but record the health-guard diagnostic and
        park it on ``failed`` instead of ``finished`` — its tokens were
        suppressed, not served."""
        assert req.state is RequestState.RUNNING, \
            "only a running request can be quarantined"
        req.error = error
        req.state = RequestState.FAILED
        self.blocks.release(req.slot)
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        self.failed.append(req)
