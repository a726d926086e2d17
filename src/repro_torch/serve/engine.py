"""Serving engines (mirror src/repro/serve/engine.py).

``ServeEngine`` — static batch: equal-length prompts are prefilled once
into a contiguous (MX) KV cache, then stepped greedily or sampled.

``ContinuousBatchingEngine`` — continuous batching over a paged MX KV
cache.  Variable-length prompts are admitted into decode slots mid-flight; each
slot's K/V lives in fixed-size pages of (bit-packed) codes + E8M0 scales
referenced through a per-slot block table, and finished requests are
evicted so their pages recycle at once.  Admissions are bucket-batched:
same-padded-length prompts prefill as one batch whose caches scatter into
their pages in one pass.  Decode runs up to ``sync_every`` steps on the
device per window (``Scheduler.plan_window`` pre-grants the pages the
window writes); the host drains the window's tokens and health flags in
one transfer, quarantines poisoned slots, evicts finished ones and admits
waiting requests only at window boundaries.  The block table is uploaded
only when the host tables changed (``BlockManager.version``).

On the card each engine runs a decode step as one replay of a captured
CUDA graph (``serve.graphs``), the counterpart of the reference's jitted
step and window; on the CPU the same step function runs as it is.
Sampling is greedy or, at a temperature, Gumbel-max with counter-based
per-slot keys from ``GenerationConfig.seed`` (``decoder.sample_tokens``).
With ``prefix_cache`` the continuous engine shares full KV pages across
requests with a common prompt prefix (``serve.prefix``): a hit maps the
cached pages read-only, forks a shared page it must write
(copy-on-write) and prefills only its uncached suffix through the paged
pool (``decoder.paged_prefill_suffix``); the tokens are those of
``prefix_cache=False`` (MX pools, or fp pools at ``attn_impl="dense"``;
an fp pool at ``"flash"`` is refused).  Left to later work:
preempt/swap, fault injection, retries, tracing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mx_weight import params_nbytes
from repro_torch.models.decoder import request_keys, sample_tokens
from repro_torch.models.health import slot_scale_poison
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.faults import scrub_pool_pages
from repro_torch.serve.graphs import PagedDecodeGraph, StaticDecodeGraph
from repro_torch.serve.paging import TRASH_PAGE, BlockManager, pages_needed
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler, request_seed


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 => greedy
    seed: int = 0


def _stream_keys(seed: int, ids, device) -> torch.Tensor:
    """Fresh sampling keys of the requests (or static rows) ``ids``."""
    seeds = torch.tensor([request_seed(seed, int(i)) for i in ids],
                         dtype=torch.int64)
    return request_keys(seeds).to(device)


class ServeEngine:
    """Static-batch serving over a contiguous KV cache of ``max_len``
    positions: one prefill, then decode steps with the position kept on
    the device — on the card one replay of a captured step per token (no
    host sync inside the decode loop), one graph per batch size and
    temperature.  Row b samples from the stream of request id b under
    ``gen.seed``."""

    def __init__(self, model: Model, params, max_len: int):
        self.model = model
        self.params = params
        self.max_len = int(max_len)
        self.kv_cache_nbytes = 0     # the last generate call's cache
        self.n_captures = 0          # decode steps captured so far
        # last call, seconds; "capture" is nonzero on a new shape only
        self.phase = {"capture": 0.0, "prefill": 0.0, "decode": 0.0}
        self._graphs: Dict[Tuple[int, float], StaticDecodeGraph] = {}

    @property
    def weight_pool_nbytes(self) -> int:
        """Serve-time weight bytes as stored (MXWeight leaves count their
        codes + E8M0 scales, fp params their dtype width)."""
        return params_nbytes(self.params)

    def _graph(self, batch: int, temperature: float) -> StaticDecodeGraph:
        key = (batch, float(temperature))
        if key not in self._graphs:
            self._graphs[key] = StaticDecodeGraph(
                self.model, self.params, batch=batch, max_len=self.max_len,
                temperature=temperature)
            self.n_captures += self.model.device.type == "cuda"
        return self._graphs[key]

    def generate(self, batch: Dict[str, np.ndarray],
                 gen: GenerationConfig = GenerationConfig()) -> np.ndarray:
        """batch: {"tokens": (B, S) int32} of equal-length prompts.
        Returns (B, max_new_tokens) int32 tokens."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"], np.int32))
        b, s = tokens.shape
        if s + gen.max_new_tokens - 1 > self.max_len:
            raise ValueError(f"prompt {s} + {gen.max_new_tokens} new tokens "
                             f"do not fit max_len={self.max_len}")
        dev = self.model.device
        vocab = self.model.cfg.vocab
        t0 = time.perf_counter()
        graph = self._graph(b, gen.temperature)
        t1 = time.perf_counter()
        logits, cache, pos = self.model.prefill(
            self.params, tokens.to(dev), max_len=self.max_len,
            cache=graph.cache)
        keys, tok = sample_tokens(logits[:, -1, :vocab],
                                  _stream_keys(gen.seed, range(b), dev),
                                  gen.temperature)
        out = [tok.cpu()[:, None]]        # ends the prefill phase
        t2 = time.perf_counter()
        n = gen.max_new_tokens - 1
        if n:
            out.append(graph.run(tok, keys, pos, n).T.cpu())
        self.phase = {"capture": t1 - t0, "prefill": t2 - t1,
                      "decode": time.perf_counter() - t2}
        self.kv_cache_nbytes = int(sum(t.numel() * t.element_size()
                                       for t in cache.values()))
        return torch.cat(out, dim=1).numpy()


class ContinuousBatchingEngine:
    """Slot-based continuous batching with a device-resident decode loop.

    ``max_slots``      — decode batch width (requests in flight).
    ``page_size``      — tokens per KV page.
    ``max_len``        — per-request cap on prompt + generated tokens; sets
                         the block-table width.
    ``num_pages``      — page-pool size; defaults to full occupancy
                         (max_slots * pages(max_len) + the trash page).
    ``gen``            — ``temperature`` and ``seed`` of every request's
                         sampling (the per-request budget comes with
                         ``add_request``).
    ``sync_every``     — decode steps per window; the host syncs only at
                         window boundaries.  Any value gives the same
                         tokens (rows of the batch are independent, and
                         a slot's keys advance with its own steps).
    ``prefill_bucket`` — prompts pad to a multiple of this (rounded up to
                         a page multiple; default page_size), and
                         same-bucket admissions prefill as one batch.
    ``prefix_cache``   — share prefixes: finished prefills (and finished
                         requests, prompt + output) publish their full KV
                         pages into a trie keyed by page token content;
                         later admissions map the longest cached prefix
                         read-only and prefill only the uncached suffix,
                         forking any shared page they must write.  The
                         tokens are those of ``prefix_cache=False`` under
                         MX KV pools (either ``attn_impl``) and fp pools
                         at ``attn_impl="dense"``; only prefill work and
                         fresh-page demand shrink.  An fp pool at
                         ``"flash"`` is refused: its cold prefill attends
                         through the flash kernel, the suffix prefill
                         densely, so the tokens could differ.
    ``health_checks``  — numeric-health guards: each prefill and decode
                         window also yields a per-slot non-finite-logits
                         flag and an MX-block poison flag (marker scale
                         bytes in the slot's live pages, a uint8
                         compare).  A flagged request is quarantined: its
                         tokens are suppressed, its pages scrubbed and
                         freed, and it is parked in ``scheduler.failed``
                         with a diagnostic; healthy slots stream on
                         token-identically.
    """

    _PHASES = ("prefill", "decode", "sync")

    def __init__(self, model: Model, params, *, max_slots: int = 8,
                 page_size: int = 16, max_len: int = 256,
                 num_pages: Optional[int] = None,
                 gen: GenerationConfig = GenerationConfig(),
                 sync_every: int = 8, prefill_bucket: Optional[int] = None,
                 prefix_cache: bool = False, health_checks: bool = True):
        if not model.supports_paged():
            raise NotImplementedError(
                f"{model.cfg.name}: continuous batching needs a GQA decoder")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        if prefix_cache and model.cfg.mx.kv_key is None \
                and model.cfg.attn_impl == "flash":
            raise ValueError(
                "prefix_cache over an fp KV pool needs attn_impl='dense': "
                "at 'flash' the cold prefill attends through the flash "
                "kernel and the suffix prefill densely, so the tokens "
                "could differ from prefix_cache=False")
        self.model = model
        self.params = params
        self.device = model.device
        self.gen = gen
        self.health_checks = bool(health_checks)
        self.page_size = page_size
        self.sync_every = int(sync_every)
        pb = page_size if prefill_bucket is None else int(prefill_bucket)
        if pb < 1:
            raise ValueError(f"prefill_bucket must be >= 1, got {pb}")
        self.prefill_bucket = -(-pb // page_size) * page_size
        self.max_pages_per_slot = pages_needed(max_len, page_size)
        if num_pages is None:
            # full occupancy: every slot can hold max_len, plus trash
            num_pages = 1 + max_slots * self.max_pages_per_slot
        self.metrics = MetricsRegistry()
        self.blocks = BlockManager(num_pages, page_size, max_slots,
                                   self.max_pages_per_slot,
                                   metrics=self.metrics)
        self.prefix = PrefixCache(self.blocks, metrics=self.metrics) \
            if prefix_cache else None
        self.scheduler = Scheduler(max_slots, self.blocks,
                                   prefix=self.prefix)
        self.pool = model.init_paged_cache(num_pages, page_size)
        self.vocab = model.cfg.vocab
        self._next_rid = 0
        self._cur_tok = np.zeros(max_slots, np.int32)
        self._lengths = np.zeros(max_slots, np.int32)
        self._remaining = np.zeros(max_slots, np.int32)
        self._bt_version = -1
        self._step_progress = False     # a quarantine counts as progress
        # the decode window's buffers and its captured step (on the card:
        # one CUDA graph, captured here on all-idle slots)
        self.window = PagedDecodeGraph(
            model, params, self.pool, slots=max_slots,
            max_pages=self.max_pages_per_slot, max_window=self.sync_every,
            temperature=gen.temperature, health=self.health_checks,
            trash_page=TRASH_PAGE)
        m = self.metrics
        self._c_steps = m.counter(
            "engine.steps", "device decode steps (incl. masked tail)")
        self._c_syncs = m.counter(
            "engine.syncs", "host sync points (decode windows run)")
        self._c_generated = m.counter(
            "engine.generated_tokens", "tokens emitted to requests")
        self._c_prefill_batches = m.counter(
            "engine.prefill_batches", "bucket prefill calls")
        self._c_hit_batches = m.counter(
            "engine.hit_prefill_batches",
            "suffix prefill calls of prefix-cache hits (also counted in "
            "engine.prefill_batches)")
        self._c_prefill_tokens = m.counter(
            "engine.prefill_tokens", "unpadded prompt positions prefilled")
        self._c_cow = m.counter(
            "engine.cow_forks", "copy-on-write page forks")
        self._c_quar = m.counter(
            "engine.quarantined", "requests parked by the health guard")
        self._g_peak_mapped = m.gauge(
            "pages.peak_mapped", "peak distinct pages in slot tables")
        self._g_peak_shared = m.gauge(
            "pages.peak_shared", "peak pages mapped by >= 2 entries")
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
    def n_hit_batches(self) -> int:
        return int(self._c_hit_batches.value())

    @property
    def n_quarantined(self) -> int:
        return int(self._c_quar.value())

    @property
    def prefill_tokens_computed(self) -> int:
        """Prompt positions prefilled (unpadded): a hit counts only its
        suffix."""
        return int(self._c_prefill_tokens.value())

    @property
    def n_cow_forks(self) -> int:
        return int(self._c_cow.value())

    @property
    def peak_mapped_pages(self) -> int:
        return int(self._g_peak_mapped.value())

    @property
    def peak_shared_pages(self) -> int:
        return int(self._g_peak_shared.value())

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

    @property
    def kv_pool_bytes_effective(self) -> int:
        """Bytes of the *distinct* pages the serving working set peaked
        at: peak pages mapped by any slot's block table times the bytes
        of one page over every layer.  A shared prefix page counts once
        however many slots map it; trie-only pins do not count."""
        return self.peak_mapped_pages \
            * (self.kv_pool_nbytes // self.blocks.num_pages)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admissions that matched a non-empty cached prefix
        (0.0 with prefix caching off or before any admission)."""
        if self.prefix is None or self.prefix.lookups == 0:
            return 0.0
        return self.prefix.hits / self.prefix.lookups

    def _note_page_stats(self) -> None:
        self._g_peak_mapped.set_max(self.blocks.mapped_pages)
        self._g_peak_shared.set_max(self.blocks.shared_pages)

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
        the (request id, token) pairs emitted, in step order.  A slot whose
        health guard trips is quarantined instead of emitting."""
        emitted: List[Tuple[int, int]] = []
        self._step_progress = False
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
        self._note_page_stats()             # post-grant working set
        snapshot = sorted(self.scheduler.running.items())
        rem0 = {slot: req.remaining for slot, req in snapshot}
        w = self.window
        self._upload_tables()
        t1 = time.perf_counter()
        w.state.copy_(torch.from_numpy(np.stack(
            [self._cur_tok, self._lengths, self._remaining])))
        w.run(window)
        flags = [w.tokens[:window].reshape(-1), w.bad.to(torch.int32)]
        if self.health_checks and self.model.cfg.mx.kv_key is not None:
            # lengths after the window: every position a slot wrote
            flags.append(slot_scale_poison(self.pool, w.block_tables,
                                           w.state[1], self.model.cfg)
                         .to(torch.int32))
        host = torch.cat(flags).cpu().numpy()   # the one transfer per window
        t2 = time.perf_counter()
        slots = w.bad.shape[0]
        toks = host[:window * slots].reshape(window, slots)
        badl = host[window * slots:(window + 1) * slots] != 0
        poison = host[(window + 1) * slots:] != 0
        if not poison.size:
            poison = np.zeros(slots, bool)
        self._c_steps.inc(window)
        self._c_syncs.inc()
        for t in range(window):
            for slot, req in snapshot:
                if badl[slot] or poison[slot]:
                    continue            # quarantined below; no tokens out
                if t < rem0[slot]:
                    tok = int(toks[t, slot])
                    req.out.append(tok)
                    emitted.append((req.rid, tok))
                    self._c_generated.inc()
        for slot, req in snapshot:
            if badl[slot] or poison[slot]:
                why = ("non-finite logits in decode window" if badl[slot]
                       else "MX scale poison marker in KV pages")
                self._quarantine(req, f"numeric-health guard: {why}")
                continue
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
        """Drive ``step()`` until every queued request finishes or is
        quarantined; returns {request id: generated tokens} for the
        requests this call finished.  Quarantined requests are not in the
        result: they sit in ``scheduler.failed`` with ``error`` set."""
        start = len(self.scheduler.finished)
        while self.scheduler.has_work():
            emitted = self.step()
            if not emitted and not self.scheduler.running \
                    and not self._step_progress:
                raise RuntimeError(
                    "no progress: waiting requests cannot be admitted")
        return {r.rid: np.asarray(r.out, np.int32)
                for r in self.scheduler.finished[start:]}

    # ------------------------------------------------------------ internals
    def _upload_tables(self) -> None:
        """Copy the host block table into the captured step's buffer, only
        when the host tables changed (admission / page grant / eviction)."""
        if self._bt_version != self.blocks.version:
            self.window.block_tables.copy_(
                torch.from_numpy(self.blocks.tables))
            self._bt_version = self.blocks.version

    def _first_tokens(self, last: torch.Tensor, rids: List[int],
                      tables: torch.Tensor, lens: torch.Tensor):
        """Sample each request's first token from its last prompt
        position's logits ``last`` (G, vocab) with its fresh keys.  With
        health checks on, a per-request flag (non-finite logits, or an MX
        poison marker in the live positions of the pages ``tables``
        names) rides the same host transfer.  Returns (first tokens,
        keys after the draw, flags)."""
        g = last.shape[0]
        keys, first = sample_tokens(
            last, _stream_keys(self.gen.seed, rids, self.device),
            self.gen.temperature)
        out = [first]
        if self.health_checks:
            bad = ~torch.isfinite(last).all(dim=-1)
            if self.model.cfg.mx.kv_key is not None:
                bad |= slot_scale_poison(self.pool, tables, lens,
                                         self.model.cfg)
            out.append(bad.to(torch.int32))
        host = torch.cat(out).cpu().numpy()
        return host[:g], keys, host[g:] != 0

    def _prefill_scatter(self, tokens: np.ndarray, lens: np.ndarray,
                         rids: List[int], page_ids: np.ndarray):
        """Prefill one bucket of G same-padded prompts, scatter every
        request's pages into the pool (packing sub-byte codes) and sample
        each request's first token from its last prompt position."""
        dev = self.device
        g = tokens.shape[0]
        logits, cache, _ = self.model.prefill(
            self.params, torch.from_numpy(tokens).to(dev),
            max_len=tokens.shape[1])
        pids = torch.from_numpy(page_ids).to(dev)
        self.model.scatter_prefill(self.pool, cache, pids)
        lens_d = torch.from_numpy(lens).to(dev)
        last = logits[torch.arange(g, device=dev),
                      lens_d.to(torch.int64) - 1, :self.vocab]
        return self._first_tokens(last, rids, pids, lens_d)

    def _batched_prefill(self, admitted: List[Request],
                         emitted: List[Tuple[int, int]]) -> None:
        """Prefill admissions bucket by bucket.  Cold admissions (no
        cached prefix) pad to the bucket and prefill as one batch whose
        pages scatter in one pass.  Prefix-cache hits take the suffix
        path: the copy-on-write forks they owe run first (one batched
        page copy), then each bucket of same-padded *suffix* lengths
        prefills only its uncached positions through the paged pool."""
        t0 = time.perf_counter()
        cold = [r for r in admitted if r.matched_tokens == 0]
        hits = [r for r in admitted if r.matched_tokens > 0]
        for lp, reqs in self._buckets(cold, lambda r: r.prompt_len):
            toks = np.zeros((len(reqs), lp), np.int32)
            lens = np.zeros(len(reqs), np.int32)
            slots = np.array([r.slot for r in reqs])
            for i, r in enumerate(reqs):
                toks[i, :r.prompt_len] = r.prompt
                lens[i] = r.prompt_len
            # rows are trash-padded past each request's allocation, so a
            # bucket-padded prompt's excess pages scatter harmlessly
            page_ids = self.blocks.tables[slots, :lp // self.page_size]
            first, keys, bad = self._prefill_scatter(
                toks, lens, [r.rid for r in reqs], page_ids)
            self.window.keys[torch.from_numpy(slots).to(self.device)] = keys
            self._c_prefill_batches.inc()
            self._finish_prefill(reqs, first, bad, emitted)
        if hits:
            self._cow_forks(hits)
            self._hit_prefill(hits, emitted)
        self._note_page_stats()
        self._phase_add("prefill", time.perf_counter() - t0)

    def _buckets(self, reqs: List[Request], tokens):
        """(padded length, requests) groups, shortest first: ``tokens(r)``
        positions rounded up to the prefill bucket."""
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            n = -(-tokens(r) // self.prefill_bucket) * self.prefill_bucket
            groups.setdefault(n, []).append(r)
        return sorted(groups.items())

    def _cow_forks(self, hits: List[Request]) -> None:
        """Fork every shared page a hit's suffix prefill will write (only
        a fully cached prompt has one: its last page is recomputed at
        position L-1 to seed the first token) and copy the page contents
        on the device, in one batch, before any write lands."""
        src, dst = [], []
        for r in hits:
            for idx in self.blocks.cow_targets(r.slot, r.prefill_start,
                                               r.prompt_len):
                pair = self.blocks.fork_page(r.slot, idx)
                assert pair is not None, \
                    "admission reserved the copy-on-write page"
                src.append(pair[0])
                dst.append(pair[1])
            r.cow_pending = 0
        if src:
            self._c_cow.inc(len(src))
            self.model.copy_pool_pages(
                self.pool, torch.tensor(src, device=self.device),
                torch.tensor(dst, device=self.device))

    def _hit_prefill(self, hits: List[Request],
                     emitted: List[Tuple[int, int]]) -> None:
        """Suffix-only prefill of prefix-cache hits, bucketed by padded
        suffix length; each hit's first token is sampled from the logits
        of its last prompt position, row ``lens - starts - 1``."""
        dev = self.device
        self._upload_tables()           # the post-fork tables
        for ls, reqs in self._buckets(
                hits, lambda r: r.prompt_len - r.prefill_start):
            g = len(reqs)
            toks = np.zeros((g, ls), np.int32)
            starts = np.zeros(g, np.int32)
            lens = np.zeros(g, np.int32)
            slots = torch.tensor([r.slot for r in reqs], device=dev)
            for i, r in enumerate(reqs):
                s0 = r.prefill_start
                toks[i, :r.prompt_len - s0] = r.prompt[s0:]
                starts[i] = s0
                lens[i] = r.prompt_len
            bt = self.window.block_tables[slots]
            starts_d = torch.from_numpy(starts).to(dev)
            lens_d = torch.from_numpy(lens).to(dev)
            logits, _ = self.model.paged_prefill_suffix(
                self.params, torch.from_numpy(toks).to(dev), starts_d,
                lens_d, self.pool, bt)
            last = logits[torch.arange(g, device=dev),
                          (lens_d - starts_d).to(torch.int64) - 1,
                          :self.vocab]
            first, keys, bad = self._first_tokens(
                last, [r.rid for r in reqs], bt, lens_d)
            self.window.keys[slots] = keys
            self._c_prefill_batches.inc()
            self._c_hit_batches.inc()
            self._finish_prefill(reqs, first, bad, emitted)

    def _finish_prefill(self, reqs: List[Request], first: np.ndarray,
                        bad: np.ndarray,
                        emitted: List[Tuple[int, int]]) -> None:
        for i, r in enumerate(reqs):
            self._c_prefill_tokens.inc(r.prompt_len - r.prefill_start)
            if bad.size and bad[i]:
                self._quarantine(
                    r, "numeric-health guard: non-finite logits or MX "
                       "poison marker at prefill")
                continue
            slot = r.slot
            tok = int(first[i])
            self._cur_tok[slot] = tok
            self._lengths[slot] = r.prompt_len
            self._remaining[slot] = r.max_new_tokens - 1
            if self.prefix is not None:
                # publish the prompt's full pages (an existing trie chain
                # dedupes; new nodes pin this slot's private pages)
                n_full = r.prompt_len // self.page_size
                self.prefix.insert(
                    r.prompt, self.blocks.slot_page_ids(slot)[:n_full])
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

    def _quarantine(self, req: Request, diag: str) -> None:
        """Park a guard-flagged request: free its slot and pages, record
        the diagnostic; its tokens were already skipped.  Its pages hold
        the poison that tripped the guard, so the ones that return to the
        free list are scrubbed to zeros before the allocator can hand
        them to a healthy slot.  Healthy slots are untouched: batch rows
        are independent, so their tokens are those of a run without the
        poisoned neighbour."""
        slot = req.slot
        ids = self.blocks.slot_page_ids(slot)
        self.scheduler.fail(req, diag)
        # only pages whose last reference this was: a shared prefix page
        # (still mapped by another slot or pinned by the trie) is read by
        # its other owners, whose own health scans judge it
        dead = [pg for pg in ids if self.blocks.page_refcount(pg) == 0]
        scrub_pool_pages(self.pool, dead)
        self._c_quar.inc()
        self._step_progress = True
        self._cur_tok[slot] = 0
        self._lengths[slot] = 0
        self._remaining[slot] = 0

    def _release(self, req: Request) -> None:
        slot = req.slot
        if self.prefix is not None:
            # publish the finished sequence's full pages before the
            # decref: positions [0, L + gen - 1) hold the KV of prompt +
            # out[:-1] (the last sampled token is never fed back), so a
            # later prompt extending this conversation matches them
            seq = np.concatenate(
                [req.prompt, np.asarray(req.out[:-1], np.int32)])
            n_full = len(seq) // self.page_size
            self.prefix.insert(seq, self.blocks.slot_page_ids(slot)[:n_full])
        self.scheduler.evict(req)
        self._cur_tok[slot] = 0
        self._lengths[slot] = 0
        self._remaining[slot] = 0
