"""Serving engines (mirror src/repro/serve/engine.py).

``ServeEngine`` — static batch: equal-length prompts are prefilled once
into a contiguous (MX) KV cache, then stepped greedily.

``ContinuousBatchingEngine`` — continuous batching over a paged MX KV
cache.  Variable-length prompts are admitted into decode slots mid-flight; each
slot's K/V lives in fixed-size pages of (bit-packed) codes + E8M0 scales
referenced through a per-slot block table, and finished requests are
evicted so their pages recycle at once.  Admissions are bucket-batched:
same-padded-length prompts prefill as one batch whose caches scatter into
their pages in one pass.  Decode runs up to ``sync_every`` greedy steps
on the device per window (``Scheduler.plan_window`` pre-grants the pages
the window writes); the host drains the window's tokens in one transfer,
evicts finished slots and admits waiting requests only at window
boundaries.  The block table is uploaded only when the host tables
changed (``BlockManager.version``).

Sampling is greedy.  Left to later work: preempt/swap, prefix caching,
fault injection and health guards, tracing, temperature sampling.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mx_weight import params_nbytes
from repro_torch.models.decoder import sample_tokens
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.paging import TRASH_PAGE, BlockManager, pages_needed
from repro_torch.serve.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 => greedy (the only mode ported)


class ServeEngine:
    """Static-batch serving over a contiguous KV cache of ``max_len``
    positions: one prefill, then greedy decode steps at host-side
    positions (no host sync inside the decode loop)."""

    def __init__(self, model: Model, params, max_len: int):
        self.model = model
        self.params = params
        self.max_len = int(max_len)
        self.kv_cache_nbytes = 0     # the last generate call's cache
        self.phase = {"prefill": 0.0, "decode": 0.0}   # last call, seconds

    @property
    def weight_pool_nbytes(self) -> int:
        """Serve-time weight bytes as stored (MXWeight leaves count their
        codes + E8M0 scales, fp params their dtype width)."""
        return params_nbytes(self.params)

    def generate(self, batch: Dict[str, np.ndarray],
                 gen: GenerationConfig = GenerationConfig()) -> np.ndarray:
        """batch: {"tokens": (B, S) int32} of equal-length prompts.
        Returns (B, max_new_tokens) int32 greedy tokens."""
        if gen.temperature > 0.0:
            raise NotImplementedError(
                "ServeEngine samples greedily; temperature sampling is not "
                "ported")
        tokens = torch.as_tensor(np.asarray(batch["tokens"], np.int32))
        s = tokens.shape[1]
        if s + gen.max_new_tokens - 1 > self.max_len:
            raise ValueError(f"prompt {s} + {gen.max_new_tokens} new tokens "
                             f"do not fit max_len={self.max_len}")
        vocab = self.model.cfg.vocab
        t0 = time.perf_counter()
        logits, cache, pos = self.model.prefill(
            self.params, tokens.to(self.model.device), max_len=self.max_len)
        tok = sample_tokens(logits[:, -1, :vocab])
        out = [tok.cpu()[:, None]]        # ends the prefill phase
        t1 = time.perf_counter()
        steps = []
        for i in range(gen.max_new_tokens - 1):
            logits, cache = self.model.decode_step(self.params, tok, cache,
                                                   pos + i)
            tok = sample_tokens(logits[:, -1, :vocab])
            steps.append(tok)
        if steps:
            out.append(torch.stack(steps, dim=1).cpu())
        self.phase = {"prefill": t1 - t0,
                      "decode": time.perf_counter() - t1}
        self.kv_cache_nbytes = int(sum(t.numel() * t.element_size()
                                       for t in cache.values()))
        return torch.cat(out, dim=1).numpy()


class ContinuousBatchingEngine:
    """Slot-based continuous batching with a device-resident decode loop.

    ``max_slots``      — decode batch width (requests in flight).
    ``page_size``      — tokens per KV page.
    ``max_len``        — per-request cap on prompt + generated tokens; sets
                         the block-table width.
    ``sync_every``     — decode steps per window; the host syncs only at
                         window boundaries.  Any value gives the same
                         tokens (rows of the batch are independent).
    ``prefill_bucket`` — prompts pad to a multiple of this (rounded up to
                         a page multiple; default page_size), and
                         same-bucket admissions prefill as one batch.
    """

    _PHASES = ("prefill", "decode", "sync")

    def __init__(self, model: Model, params, *, max_slots: int = 8,
                 page_size: int = 16, max_len: int = 256,
                 sync_every: int = 8, prefill_bucket: Optional[int] = None):
        if not model.supports_paged():
            raise NotImplementedError(
                f"{model.cfg.name}: continuous batching needs a GQA decoder")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.model = model
        self.params = params
        self.device = model.device
        self.page_size = page_size
        self.sync_every = int(sync_every)
        pb = page_size if prefill_bucket is None else int(prefill_bucket)
        if pb < 1:
            raise ValueError(f"prefill_bucket must be >= 1, got {pb}")
        self.prefill_bucket = -(-pb // page_size) * page_size
        self.max_pages_per_slot = pages_needed(max_len, page_size)
        # full occupancy: every slot can hold max_len, plus the trash page
        num_pages = 1 + max_slots * self.max_pages_per_slot
        self.metrics = MetricsRegistry()
        self.blocks = BlockManager(num_pages, page_size, max_slots,
                                   self.max_pages_per_slot,
                                   metrics=self.metrics)
        self.scheduler = Scheduler(max_slots, self.blocks)
        self.pool = model.init_paged_cache(num_pages, page_size)
        self.vocab = model.cfg.vocab
        self._next_rid = 0
        self._cur_tok = np.zeros(max_slots, np.int32)
        self._lengths = np.zeros(max_slots, np.int32)
        self._remaining = np.zeros(max_slots, np.int32)
        self._bt_version = -1
        self._bt_dev: Optional[torch.Tensor] = None
        m = self.metrics
        self._c_steps = m.counter(
            "engine.steps", "device decode steps (incl. masked tail)")
        self._c_syncs = m.counter(
            "engine.syncs", "host sync points (decode windows run)")
        self._c_generated = m.counter(
            "engine.generated_tokens", "tokens emitted to requests")
        self._c_prefill_batches = m.counter(
            "engine.prefill_batches", "bucket prefill calls")
        self._c_phase = m.counter(
            "engine.phase_s", "wall seconds by engine phase")
        for k in self._PHASES:
            self._c_phase.inc(0.0, phase=k)

    # ------------------------------------------------------------ counters
    @property
    def n_steps(self) -> int:
        return int(self._c_steps.value())

    @property
    def n_syncs(self) -> int:
        return int(self._c_syncs.value())

    @property
    def n_generated(self) -> int:
        return int(self._c_generated.value())

    @property
    def n_prefill_batches(self) -> int:
        return int(self._c_prefill_batches.value())

    @property
    def phase(self) -> Dict[str, float]:
        """Per-phase wall clock (seconds; each phase ends in a host sync)."""
        return {k: float(self._c_phase.value(phase=k))
                for k in self._PHASES}

    def _phase_add(self, k: str, dt: float) -> None:
        self._c_phase.inc(max(0.0, dt), phase=k)

    @property
    def kv_pool_nbytes(self) -> int:
        """Allocated page-pool bytes, summed over layers."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.pool.values()))

    @property
    def weight_pool_nbytes(self) -> int:
        """Serve-time weight bytes as stored: MXWeight leaves count their
        (bit-packed) codes + E8M0 scales, fp params their dtype width."""
        return params_nbytes(self.params)

    # ------------------------------------------------------------ requests
    def add_request(self, prompt, max_new_tokens: int) -> int:
        """Queue a prompt; returns the request id.  Raises ValueError when
        the sequence can never fit a slot or the pool."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always "
                             "emits the first generated token)")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens)
        self.scheduler.submit(req)
        self._next_rid += 1
        return req.rid

    def step(self) -> List[Tuple[int, int]]:
        """One host sync cycle: admit what fits (bucket-batched prefill),
        run one decode window of up to ``sync_every`` device steps; returns
        the (request id, token) pairs emitted, in step order."""
        emitted: List[Tuple[int, int]] = []
        t0 = time.perf_counter()
        admitted = self.scheduler.admit()
        self._phase_add("sync", time.perf_counter() - t0)
        if admitted:
            self._batched_prefill(admitted, emitted)
        t0 = time.perf_counter()
        if not self.scheduler.running:
            self._phase_add("sync", time.perf_counter() - t0)
            return emitted
        window = self.scheduler.plan_window(self._lengths, self.sync_every)
        snapshot = sorted(self.scheduler.running.items())
        rem0 = {slot: req.remaining for slot, req in snapshot}
        bt = self._device_tables()
        dev = self.device
        t1 = time.perf_counter()
        toks, self.pool, _, _ = self.model.paged_decode_multi_step(
            self.params, torch.from_numpy(self._cur_tok).to(dev), self.pool,
            bt, torch.from_numpy(self._lengths).to(dev),
            torch.from_numpy(self._remaining).to(dev), n_steps=window,
            trash_page=TRASH_PAGE)
        toks = toks.cpu().numpy()     # the one host transfer per window
        t2 = time.perf_counter()
        self._c_steps.inc(window)
        self._c_syncs.inc()
        for t in range(window):
            for slot, req in snapshot:
                if t < rem0[slot]:
                    tok = int(toks[t, slot])
                    req.out.append(tok)
                    emitted.append((req.rid, tok))
                    self._c_generated.inc()
        for slot, req in snapshot:
            take = min(window, rem0[slot])
            self._lengths[slot] += take
            self._remaining[slot] -= take
            if take:
                self._cur_tok[slot] = toks[take - 1, slot]
            if req.done:
                self._release(req)
        self._phase_add("decode", t2 - t1)
        self._phase_add("sync", (t1 - t0) + (time.perf_counter() - t2))
        return emitted

    def run(self) -> Dict[int, np.ndarray]:
        """Drive ``step()`` until every queued request finishes; returns
        {request id: generated tokens} for the requests this call
        finished."""
        start = len(self.scheduler.finished)
        while self.scheduler.has_work():
            emitted = self.step()
            if not emitted and not self.scheduler.running:
                raise RuntimeError(
                    "no progress: waiting requests cannot be admitted")
        return {r.rid: np.asarray(r.out, np.int32)
                for r in self.scheduler.finished[start:]}

    # ------------------------------------------------------------ internals
    def _device_tables(self) -> torch.Tensor:
        """Device block table, re-uploaded only when the host tables
        changed (admission / page grant / eviction)."""
        if self._bt_version != self.blocks.version:
            self._bt_dev = torch.from_numpy(self.blocks.tables).to(
                self.device)
            self._bt_version = self.blocks.version
        return self._bt_dev

    def _prefill_scatter(self, tokens: np.ndarray, lens: np.ndarray,
                         page_ids: np.ndarray) -> np.ndarray:
        """Prefill one bucket of G same-padded prompts, scatter every
        request's pages into the pool (packing sub-byte codes) and pick
        each request's first token from its last prompt position."""
        dev = self.device
        tok_d = torch.from_numpy(tokens).to(dev)
        logits, cache, _ = self.model.prefill(self.params, tok_d,
                                              max_len=tokens.shape[1])
        self.pool = self.model.scatter_prefill(
            self.pool, cache, torch.from_numpy(page_ids).to(dev))
        rows = torch.arange(tokens.shape[0], device=dev)
        last_pos = torch.from_numpy(lens - 1).to(dev).to(torch.int64)
        first = sample_tokens(logits[rows, last_pos, :self.vocab])
        return first.cpu().numpy()

    def _batched_prefill(self, admitted: List[Request],
                         emitted: List[Tuple[int, int]]) -> None:
        t0 = time.perf_counter()
        groups: Dict[int, List[Request]] = {}
        for req in admitted:
            lp = -(-req.prompt_len // self.prefill_bucket) \
                * self.prefill_bucket
            groups.setdefault(lp, []).append(req)
        for lp, reqs in sorted(groups.items()):
            toks = np.zeros((len(reqs), lp), np.int32)
            lens = np.zeros(len(reqs), np.int32)
            slots = np.array([r.slot for r in reqs])
            for i, r in enumerate(reqs):
                toks[i, :r.prompt_len] = r.prompt
                lens[i] = r.prompt_len
            # rows are trash-padded past each request's allocation, so a
            # bucket-padded prompt's excess pages scatter harmlessly
            page_ids = self.blocks.tables[slots, :lp // self.page_size]
            first = self._prefill_scatter(toks, lens, page_ids)
            self._c_prefill_batches.inc()
            self._finish_prefill(reqs, first, emitted)
        self._phase_add("prefill", time.perf_counter() - t0)

    def _finish_prefill(self, reqs: List[Request], first: np.ndarray,
                        emitted: List[Tuple[int, int]]) -> None:
        for i, r in enumerate(reqs):
            slot = r.slot
            tok = int(first[i])
            self._cur_tok[slot] = tok
            self._lengths[slot] = r.prompt_len
            self._remaining[slot] = r.max_new_tokens - 1
            r.out.append(tok)
            self._c_generated.inc()
            emitted.append((r.rid, tok))
            if r.done:
                self._release(r)
            else:
                # the first decode write may sit in a page past the
                # prompt's allocation; admission reserved it
                granted = self.blocks.ensure(slot, r.prompt_len + 1)
                assert granted, "admission reserved the first decode page"

    def _release(self, req: Request) -> None:
        slot = req.slot
        self.scheduler.evict(req)
        self._cur_tok[slot] = 0
        self._lengths[slot] = 0
        self._remaining[slot] = 0
