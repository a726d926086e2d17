"""Slot-based continuous-batching scheduler with FIFO admission.

Requests arrive with arbitrary prompt lengths and generation budgets; the
scheduler admits them into a fixed number of decode slots as slots and KV
pages free up, and evicts them on completion.  Admission is conservative:
a request is only admitted when the pool can hold its whole sequence
(prompt + max_new_tokens), so an in-flight request can never stall on
page exhaustion.

SLO classes, preempt-and-swap, quarantine and prefix-cache admission are
left to the slices that port them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List

import numpy as np

from repro_torch.serve.paging import BlockManager, pages_needed


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request's lifecycle through the engine."""
    rid: int
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int
    state: RequestState = RequestState.WAITING
    slot: int = -1
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

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
    ``blocks``."""

    def __init__(self, max_slots: int, blocks: BlockManager):
        self.max_slots = max_slots
        self.blocks = blocks
        self.waiting: List[Request] = []        # arrival order
        self.running: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []
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
        """Pages the running set is still entitled to consume.  Admission
        must leave these uncommitted or a running slot could stall on page
        exhaustion mid-generation."""
        return sum(
            pages_needed(r.total_len, self.blocks.page_size)
            - self.blocks.slot_pages(r.slot)
            for r in self.running.values())

    def admit(self) -> List[Request]:
        """Admit waiting requests in arrival order — no head-of-line
        bypass — while a slot is free and the pool can hold their full
        sequence on top of what the running set is already entitled to.
        Each admitted slot is granted its prompt's pages."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            need = pages_needed(req.total_len, self.blocks.page_size)
            if need > self.blocks.free_pages - self._outstanding_pages():
                break
            slot = self._free_slots.pop()
            ok = self.blocks.allocate(
                slot, pages_needed(req.prompt_len, self.blocks.page_size))
            assert ok
            req.slot = slot
            req.state = RequestState.RUNNING
            self.running[slot] = req
            self.waiting.pop(0)
            admitted.append(req)
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
