"""Slot-based continuous-batching scheduler with SLO-class admission and
preempt-and-swap (mirrors src/repro/serve/scheduler.py).

Requests arrive with arbitrary prompt lengths, generation budgets and an
SLO class (``priority``: lower is more urgent; an optional
time-to-first-token ``deadline_s``); the scheduler admits them into a
fixed number of decode slots as slots and KV pages free up, and evicts
them on completion.  Admission order is (priority, EDF deadline,
arrival): FIFO within a class, so a queue of default-class requests
admits in arrival order.  Admission is conservative: a request is only
admitted when the pool can hold its whole sequence (prompt +
max_new_tokens), so an in-flight request never stalls on page
exhaustion.

With a :class:`~repro_torch.serve.prefix.PrefixCache` installed,
admission maps the longest cached full-page prefix of each prompt
read-only into the new slot and charges only the private remainder
against the pool (:meth:`Scheduler.admit`).

**Preempt-and-swap**: when the head of the queue cannot be admitted and
a strictly lower-priority request is running, :meth:`pick_victim`
nominates the youngest of the least important runners; the engine copies
its KV pages to the host swap store (MX codes stay packed) and calls
:meth:`preempt`, which frees the slot and re-queues the victim at its
original (priority, deadline, arrival) rank.  A restored request skips
prefill: admission allocates the number of private pages it held and the
engine writes the saved contents back.

A request whose numeric-health guard trips is quarantined
(:meth:`Scheduler.fail`): its slot and pages free as on eviction, and it
is parked on ``failed`` with a diagnostic; :meth:`requeue` puts it back
in the queue for a retry.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models.decoder import mix32
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.paging import BlockManager, PageGrantError, pages_needed
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
    SWAPPED = "swapped"         # preempted; KV pages live in the swap store
    FINISHED = "finished"
    FAILED = "failed"           # quarantined by a numeric-health guard


@dataclasses.dataclass
class Request:
    """One generation request's lifecycle through the engine."""
    rid: int
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int
    # ---- SLO class -------------------------------------------------------
    priority: int = 0                   # lower = more urgent
    deadline_s: Optional[float] = None  # TTFT target, seconds from arrival
    # ----------------------------------------------------------------------
    state: RequestState = RequestState.WAITING
    slot: int = -1
    out: List[int] = dataclasses.field(default_factory=list)
    # prefix-cache admission outcome (0 with sharing off or on a miss):
    # tokens covered by pages mapped read-only from the prefix trie, and
    # the copy-on-write forks the engine still owes before prefill (a
    # fully cached prompt forks its last page to rewrite position L-1)
    matched_tokens: int = 0
    cow_pending: int = 0
    # ---- scheduling / preemption state ----------------------------------
    seq: int = -1                       # arrival rank (set by submit)
    swap_pages: int = 0                 # pages to re-allocate on restore
    n_preemptions: int = 0
    # ---- fault tolerance -------------------------------------------------
    error: Optional[str] = None         # quarantine diagnostic (FAILED)
    n_retries: int = 0                  # times re-queued after quarantine
    # ---- latency stamps (time.perf_counter) ------------------------------
    arrival_t: Optional[float] = None   # at add_request
    t_admitted: Optional[float] = None  # first admission
    t_tokens: List[float] = dataclasses.field(default_factory=list)
    t_finished: Optional[float] = None

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

    @property
    def ttft_s(self) -> Optional[float]:
        """Arrival -> first visible token (None until both exist)."""
        if self.arrival_t is None or not self.t_tokens:
            return None
        return self.t_tokens[0] - self.arrival_t

    @property
    def itl_s(self) -> List[float]:
        """Gaps between visible token stamps.  Tokens of one decode window
        share the window's host-transfer stamp, so a gap of ~0 is the
        honest latency of window delivery."""
        return [b - a for a, b in zip(self.t_tokens, self.t_tokens[1:])]

    @property
    def deadline_met(self) -> Optional[bool]:
        """TTFT SLO outcome (None without a deadline or a first token)."""
        if self.deadline_s is None:
            return None
        t = self.ttft_s
        return None if t is None else t <= self.deadline_s


def _order(req: Request):
    """Admission rank: priority class first, earliest TTFT deadline (EDF)
    within a class, then arrival order.  Default-class requests with no
    deadline reduce to FIFO."""
    if req.arrival_t is not None and req.deadline_s is not None:
        dl = req.arrival_t + req.deadline_s
    else:
        dl = float("inf")
    return (req.priority, dl, req.seq)


class Scheduler:
    """Admission into ``max_slots`` decode slots backed by ``blocks`` in
    (priority, deadline, arrival) order, sharing cached prefixes through
    ``prefix`` when given."""

    def __init__(self, max_slots: int, blocks: BlockManager,
                 prefix: Optional[PrefixCache] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.max_slots = max_slots
        self.blocks = blocks
        self.prefix = prefix
        self.waiting: List[Request] = []        # kept sorted by _order
        self.running: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []
        self.failed: List[Request] = []         # quarantined
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._seq = 0
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._c_preempt = self.metrics.counter(
            "sched.preemptions", "preempt() calls")
        self._c_restores = self.metrics.counter(
            "sched.restores", "SWAPPED re-admissions")

    # registry-backed views (setters: snapshot restore rewinds them)
    @property
    def n_preemptions(self) -> int:
        return int(self._c_preempt.value())

    @n_preemptions.setter
    def n_preemptions(self, v: int) -> None:
        self._c_preempt.set(int(v))

    @property
    def n_restores(self) -> int:
        return int(self._c_restores.value())

    @n_restores.setter
    def n_restores(self, v: int) -> None:
        self._c_restores.set(int(v))

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
        if req.seq < 0:
            req.seq = self._seq
            self._seq += 1
        bisect.insort(self.waiting, req, key=_order)

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

    def _private_need(self, req: Request):
        """(cached pages, matched tokens, copy-on-write forks owed, fresh
        pages) of admitting ``req`` now; a restore takes no prefix
        lookup."""
        pages: List[int] = []
        matched = 0
        if self.prefix is not None and req.state is not RequestState.SWAPPED:
            pages, matched = self.prefix.lookup(req.prompt)
        cow = 1 if matched and matched >= req.prompt_len else 0
        need = pages_needed(req.total_len, self.blocks.page_size) \
            - len(pages) + cow
        return pages, matched, cow, need

    def admit(self) -> List[Request]:
        """Admit waiting requests in (priority, deadline, arrival) order —
        no head-of-line bypass — while a slot is free and the pool can
        hold their full sequence on top of what the running set is
        already entitled to.

        With a prefix cache, the longest cached full-page prefix of each
        prompt is mapped read-only into the new slot (refcount++, no
        fresh pages) and only the *private* remainder — uncached prompt
        pages, decode growth, and the copy-on-write fork of a fully
        cached prompt's last page — is charged against the free pool.
        When pinned-but-unmapped trie pages are all that stand between a
        request and admission, the trie reclaims them LRU-first; if the
        request still does not fit, the tentative mapping is backed out
        and it waits.  Each admitted slot is granted its prompt's private
        pages.

        A SWAPPED request (preempted earlier) is re-admitted without a
        prefix lookup: it gets as many private pages as it held at
        swap-out, and the engine restores their contents from the host
        swap store instead of prefilling."""
        admitted = []
        ps = self.blocks.page_size
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            restoring = req.state is RequestState.SWAPPED
            pages, matched, cow, need_private = self._private_need(req)
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
                break                       # in-class FIFO: wait
            self._free_slots.pop()
            if restoring:
                priv = req.swap_pages
                self._c_restores.inc()
            else:
                priv = pages_needed(req.prompt_len, ps) - len(pages)
            if priv > 0:
                ok = self.blocks.allocate(slot, priv)
                assert ok
            req.slot = slot
            req.matched_tokens = matched
            req.cow_pending = cow
            req.state = RequestState.RUNNING
            if req.t_admitted is None:
                req.t_admitted = time.perf_counter()
            self.running[slot] = req
            self.waiting.pop(0)
            admitted.append(req)
            if self.prefix is not None and not restoring:
                self.prefix.record(matched)
        return admitted

    # --------------------------------------------------- preempt-and-swap
    def _fits(self, req: Request) -> bool:
        """Would :meth:`admit` take ``req`` right now?  The conservative
        twin of admit's arithmetic (no trie reclaim): a free slot and
        enough uncommitted pages for the private part of its sequence."""
        if not self._free_slots:
            return False
        need = self._private_need(req)[3]
        return need <= self.blocks.free_pages - self._outstanding_pages()

    def can_admit_now(self, prompt, max_new_tokens: int) -> bool:
        """Reject-on-full probe (``AsyncServer(admission="reject")``):
        would a fresh request start at once — nothing queued ahead of it,
        and a slot and pages free?"""
        if self.waiting:
            return False
        return self._fits(Request(rid=-1,
                                  prompt=np.asarray(prompt, np.int32),
                                  max_new_tokens=max_new_tokens))

    def pick_victim(self) -> Optional[Request]:
        """Nominate a running request to preempt so the head of the
        waiting queue can be admitted: only when the head cannot fit as
        it is and a *strictly* lower-priority request runs (strictness
        prevents same-class thrash).  Among candidates the youngest of
        the least important class goes: it has the least sunk decode work
        of the requests the SLO ranks lowest.  None when no preemption is
        warranted; the engine calls this in a loop, one victim at a time,
        until the head fits or no candidate remains."""
        if not self.waiting:
            return None
        head = self.waiting[0]
        if self._fits(head):
            return None                     # admit() takes it as it is
        cands = [r for r in self.running.values()
                 if r.priority > head.priority]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.priority, r.seq))

    def preempt(self, req: Request) -> None:
        """Book-keep a preemption *after* the engine copied the victim's
        pages to the swap store: free the slot (its pages nobody else
        maps or pins return to the pool) and re-queue the request at its
        original rank, ahead of later arrivals of its class."""
        assert req.state is RequestState.RUNNING, \
            "only a running request can be preempted"
        assert req.swap_pages > 0, \
            "preempt() requires the engine to have swapped the pages out"
        slot = req.slot
        self.blocks.swap_out(slot)
        del self.running[slot]
        self._free_slots.append(slot)
        req.slot = -1
        req.matched_tokens = 0              # restored pages are private
        req.cow_pending = 0
        req.state = RequestState.SWAPPED
        req.n_preemptions += 1
        self._c_preempt.inc()
        bisect.insort(self.waiting, req, key=_order)

    # ------------------------------------------------- decode-window planning
    def grant_horizon(self, req: Request, length: int) -> int:
        """Decode steps ``req``'s slot can take before its next KV write
        would land past the pages it owns (writes go to positions
        ``length``, ``length + 1``, ...)."""
        return self.blocks.slot_capacity(req.slot) - length

    def plan_window(self, lengths, sync_every: int) -> int:
        """Plan the next device-resident decode window.

        Returns the number of decode steps to run — ``sync_every`` capped
        by the longest remaining generation budget (so a window is never
        all dead steps), rounded up to a power of two as the reference
        does — and pre-grants every running slot the pages its window
        writes need, clamped to the request's reserved full-sequence
        capacity.  Because admission reserved that capacity a grant fails
        only on an allocator fault; it raises :class:`PageGrantError`
        naming the slot, and the engine swaps that request out (it
        resumes token-identically later).  Slots whose budget runs out
        inside the window are masked on device (their writes land on the
        trash page) and recycled at the next sync point.
        """
        if not self.running:
            return 0
        need = max(r.remaining for r in self.running.values())
        window = min(max(1, int(sync_every)),
                     1 << (need - 1).bit_length())
        for slot, req in self.running.items():
            tgt = min(int(lengths[slot]) + window + 1, req.total_len)
            if not self.blocks.ensure(slot, tgt):
                raise PageGrantError(
                    slot, pages_needed(tgt, self.blocks.page_size)
                    - self.blocks.slot_pages(slot))
            assert self.grant_horizon(req, int(lengths[slot])) \
                >= min(window, req.remaining), "page grant below horizon"
        return window

    def evict(self, req: Request) -> None:
        """Release a finished request's slot: every page is decref'd —
        pages still shared with other slots or pinned by the prefix cache
        stay live, the rest return to the free list."""
        req.state = RequestState.FINISHED
        self.blocks.release(req.slot)
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        self.finished.append(req)

    # ---------------------------------------------------- fault tolerance
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

    def requeue(self, req: Request) -> None:
        """Re-queue a quarantined request for a retry: reset its
        generation state (same rid, so its sampling stream restarts and a
        clean replay is token-identical) and re-enter the waiting queue at
        its original arrival rank.  The request leaves ``failed``."""
        assert req.state is RequestState.FAILED, \
            "only a quarantined request can be requeued"
        self.failed.remove(req)
        req.state = RequestState.WAITING
        req.error = None
        req.out = []
        req.t_tokens = []
        req.t_finished = None
        req.matched_tokens = 0
        req.cow_pending = 0
        req.swap_pages = 0
        req.n_retries += 1
        bisect.insort(self.waiting, req, key=_order)
