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
an fp pool at ``"flash"`` is refused).  Requests carry an SLO class
(``priority``, ``deadline_s``) and are admitted in (priority, deadline,
arrival) order; with ``preempt`` a more urgent request that cannot be
admitted swaps a less urgent one out: its packed pages go to pinned host
memory (``serve.swap``) and come back page for page on re-admission,
written into the pool the captured graph reads, with its sampling key,
so its tokens are those of a run without the preemption.
``serve.snapshot`` checkpoints and rewinds the whole engine.

Sharded serving (``rules=``, the reference's decode-posture rule table,
with this rank's mesh installed by ``dist.sharding.set_mesh`` when the
engine is built): every rank runs one engine over its shard of the
params (``dist.sharding.shard_params``) and the same requests.  The
layers split heads, MLP columns and experts over "model" with their own
collectives; the engine splits the batch rows (static) or the decode
slots (continuous) over the ``kv_batch`` axes where they divide, and at
every host transfer (a prefill's first tokens, a window's tokens and
health flags) gathers the ranks' values, so every rank's scheduler sees
the same tokens and makes the same decisions.  Under ``kv_pages`` (the
launcher's ``--shard-pool``) each data rank holds its own run of pages
(``BlockManager(partitions=)``), its block-table rows in local page ids,
and the paged attention kernel reads that pool as it is.  A mesh whose
collectives are staged through host memory (gloo with ranks sharing a
card) decodes eagerly: a CUDA graph cannot hold host work; the engine
decides that from the mesh's backend (``captures``), never by trying.
Under NCCL it captures; a captured step with an NCCL collective between
cards is not verified yet (one card: at world one every axis has size 1
and the layers skip their collectives; ROADMAP A11.2).  Prefix caching,
preemption and fault
plans need every slot's pages on every rank, so they are refused where
the slots split over data ranks.

Recovery is provable through a seeded fault plan (``serve.faults``):
the engine consults it at the reference's sites (``stall`` and
``page_corrupt`` once per step, ``prefill_nan`` per admission,
``alloc_fail`` through the block manager, ``swap_corrupt`` through the
swap store), writes poison into the live pool in place and quarantines
what the health guards catch; the front end's watchdog
(``AsyncServer(watchdog_s=...)``) aborts a stalled step and restores the
last snapshot.  The reference's ``kernel_fail`` site degrades a failed
kernel to a dense path, which the port does not have: a plan holding it
is refused.  A ``tracer`` (``obs.trace``) records per-request and engine
spans from the ``time.perf_counter`` stamps the engine already takes (no
extra synchronize, no extra host transfer), and ``obs_interval`` samples
the ``mx.*`` health gauges (``obs.mxhealth``) every N windows, after the
window's host transfer and outside the captured graph.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mx_weight import params_nbytes
from repro_torch.dist.sharding import (current_mesh, rule_axes, rule_index,
                                       rule_size, use_sharding)
from repro_torch.models.decoder import request_keys, sample_tokens
from repro_torch.models.health import slot_scale_poison
from repro_torch.models.layers import (any_fp_kv, any_mx_kv, group_leaves,
                                       kv_groups)
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import MetricsRegistry, rate
from repro_torch.obs.mxhealth import sample_mx_health
from repro_torch.obs.trace import Tracer
from repro_torch.serve import faults as F
from repro_torch.serve.graphs import PagedDecodeGraph, StaticDecodeGraph
from repro_torch.serve.paging import (TRASH_PAGE, BlockManager,
                                      PageGrantError, pages_needed)
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import (Request, RequestState, Scheduler,
                                         request_seed)
from repro_torch.serve.swap import (HostSwapStore, SwapData,
                                    concat_snapshots, gather_pages,
                                    scatter_pages, sync, to_host)
from repro_torch.tree import leaves as tree_leaves


KERNEL_FAIL_REFUSED = (
    "fault site 'kernel_fail': the reference degrades a failed kernel to "
    "its dense path; the port has no degraded path (a kernel launch that "
    "fails raises), so there is no recovery to inject this fault into")


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 => greedy
    seed: int = 0


def _series(attr: str) -> property:
    """An int view of the registry series ``self.<attr>``; the setter
    exists for snapshot restore, which rewinds the counters."""
    return property(lambda self: int(getattr(self, attr).value()),
                    lambda self, v: getattr(self, attr).set(int(v)))


SHARDED_SLOTS_REFUSED = (
    "prefix caching, preemption and fault plans need every slot's KV "
    "pages on every rank; with the decode slots split over the data axes "
    "each rank holds only its own (ROADMAP A11.2)")


def _shard_init(eng, rules: Optional[dict]) -> None:
    """An engine's sharding state: its rules and the mesh installed now
    (reinstalled around every model call by ``eng._ctx()``), the data and
    model axes, and whether decode steps are captured (on the card,
    unless the mesh stages its collectives through host memory)."""
    eng.rules = rules
    eng.mesh = current_mesh() if rules is not None else None
    if rules is not None and eng.mesh is None:
        raise ValueError("rules= needs this rank's mesh installed "
                         "(dist.sharding.set_mesh) while the engine is "
                         "built")
    eng._ctx = lambda: use_sharding(eng.rules, eng.mesh)
    with eng._ctx():
        eng._data_axes = rule_axes("kv_batch")
        eng._model_axes = rule_axes("model")
        eng._n_data, eng._i_data = rule_size("kv_batch"), \
            rule_index("kv_batch")
    eng.captures = eng.model.device.type == "cuda" and not (
        eng.mesh is not None and eng.mesh.staged)


def _split_rows(eng, n: int) -> slice:
    """This rank's run of ``n`` batch rows or slots: split over the
    ``kv_batch`` axes where they divide ``n``, else every row (the
    reference's wrappers take the unsharded route there)."""
    k = eng._n_data
    if k == 1 or n % k:
        return slice(0, n)
    return slice(eng._i_data * (n // k), (eng._i_data + 1) * (n // k))


def _stream_keys(seed: int, ids, device) -> torch.Tensor:
    """Fresh sampling keys of the requests (or static rows) ``ids``."""
    seeds = torch.tensor([request_seed(seed, int(i)) for i in ids],
                         dtype=torch.int64)
    return request_keys(seeds).to(device)


class ServeEngine:
    """Static-batch serving over a contiguous KV cache of ``max_len``
    positions (a recurrent state for RWKV, KV caches and Mamba2 states
    for the hybrid, self and cross caches for the encoder-decoder): one
    prefill, then decode steps with the position kept on the device — on
    the card one replay of a captured step per token (no host sync inside
    the decode loop), one graph per batch size, temperature and encoder
    length.  Row b samples from the stream of request id b under
    ``gen.seed``.  ``rules`` (the decode-posture table of
    ``dist.sharding.make_rules``, with the rank's mesh installed while
    the engine is built) serves sharded: see the module docstring."""

    def __init__(self, model: Model, params, max_len: int,
                 rules: Optional[dict] = None):
        self.model = model
        self.params = params
        self.max_len = int(max_len)
        _shard_init(self, rules)
        self.kv_cache_nbytes = 0     # the last generate call's cache
        self.n_captures = 0          # decode steps captured so far
        # last call, seconds; "capture" is nonzero on a new shape only
        self.phase = {"capture": 0.0, "prefill": 0.0, "decode": 0.0}
        self._graphs: Dict[tuple, StaticDecodeGraph] = {}

    @property
    def weight_pool_nbytes(self) -> int:
        """Serve-time weight bytes as stored (MXWeight leaves count their
        codes + E8M0 scales, fp params their dtype width)."""
        return params_nbytes(self.params)

    def _graph(self, batch: int, temperature: float,
               s_enc: int = 0) -> StaticDecodeGraph:
        # an encoder-decoder's step is also keyed by its encoder length
        key = (batch, float(temperature)) + ((s_enc,) if s_enc else ())
        if key not in self._graphs:
            self._graphs[key] = StaticDecodeGraph(
                self.model, self.params, batch=batch, max_len=self.max_len,
                temperature=temperature, s_enc=s_enc, capture=self.captures)
            self.n_captures += self.captures
        return self._graphs[key]

    def generate(self, batch: Dict[str, np.ndarray],
                 gen: GenerationConfig = GenerationConfig()) -> np.ndarray:
        """batch: the reference's input dict of equal-length prompts,
        {"tokens": (B, S) int32} and, for its family, ``prefix_embeds``
        (B, P, d) (decode then starts at P + S) or ``frames`` (B, S_enc,
        d).  Returns (B, max_new_tokens) int32 tokens."""
        batch = dict(batch)
        batch["tokens"] = np.asarray(batch["tokens"], np.int32)
        b, s = batch["tokens"].shape
        cfg = self.model.cfg
        pe = batch.get("prefix_embeds")
        n_pos = s + (0 if pe is None else np.shape(pe)[1])
        if n_pos + gen.max_new_tokens - 1 > self.max_len:
            raise ValueError(f"prompt {n_pos} + {gen.max_new_tokens} new "
                             f"tokens do not fit max_len={self.max_len}")
        s_enc = np.shape(batch["frames"])[1] if cfg.family == "encdec" \
            else 0
        dev = self.model.device
        rows = _split_rows(self, b)
        if rows != slice(0, b):           # this rank's rows of the batch
            batch = {k: np.asarray(v)[rows] for k, v in batch.items()}
        bl = rows.stop - rows.start
        t0 = time.perf_counter()
        with self._ctx():
            graph = self._graph(bl, gen.temperature, s_enc)
            t1 = time.perf_counter()
            logits, cache, pos = self.model.prefill(
                self.params, batch, max_len=self.max_len, cache=graph.cache)
            keys, tok = sample_tokens(
                logits[:, -1, :cfg.vocab],
                _stream_keys(gen.seed, range(rows.start, rows.stop), dev),
                gen.temperature)
            out = [tok.cpu()[:, None]]        # ends the prefill phase
            t2 = time.perf_counter()
            n = gen.max_new_tokens - 1
            if n:
                out.append(graph.run(tok, keys, pos, n).T.cpu())
        self.phase = {"capture": t1 - t0, "prefill": t2 - t1,
                      "decode": time.perf_counter() - t2}
        self.kv_cache_nbytes = int(sum(t.numel() * t.element_size()
                                       for t in tree_leaves(cache)))
        toks = torch.cat(out, dim=1).numpy()
        if bl != b:                       # every rank's rows, in order
            toks = self.mesh.host_gather(toks, self._data_axes)
            toks = toks.reshape(b, -1)
        return toks


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
    ``preempt``        — preempt-and-swap: when the waiting head cannot be
                         admitted and a strictly lower-priority request
                         runs, the victim's KV pages (MX codes still
                         packed) go to the host swap store, its slot is
                         freed, and on re-admission the pages and its
                         sampling key come back, so its tokens are those
                         of a run without the preemption.
    ``faults``         — optional ``serve.faults.FaultPlan`` consulted at
                         its named sites (page_corrupt / swap_corrupt /
                         prefill_nan / alloc_fail / stall) for
                         deterministic fault-injection tests and recovery
                         drills; None adds no per-step work.  A plan that
                         holds ``kernel_fail`` raises ValueError: the port
                         has no degraded path to recover through.
    ``metrics``        — a shared :class:`~repro_torch.obs.metrics
                         .MetricsRegistry`; None creates a private one.
                         Every serving series (engine, scheduler, block
                         manager, prefix cache, swap store) lives in it.
    ``tracer``         — optional :class:`~repro_torch.obs.trace.Tracer`:
                         per-request spans (queued / prefill / decode
                         windows / preempt / restore / quarantine /
                         retry) and engine phase spans, recorded from the
                         stamps the engine already takes; the tokens are
                         those of a run without it.
    ``obs_interval``   — sample the MX-health gauges (``mx.*``: scale
                         poison markers, saturation / clip and underflow
                         rates per KV role) every N sync windows; 0
                         never samples.  Each sample is one device
                         reduction and one host transfer.
    """

    _PHASES = ("prefill", "decode", "sync", "swap")

    def __init__(self, model: Model, params, *, max_slots: int = 8,
                 page_size: int = 16, max_len: int = 256,
                 num_pages: Optional[int] = None,
                 gen: GenerationConfig = GenerationConfig(),
                 sync_every: int = 8, prefill_bucket: Optional[int] = None,
                 prefix_cache: bool = False, preempt: bool = False,
                 health_checks: bool = True,
                 faults: Optional[F.FaultPlan] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, obs_interval: int = 0,
                 rules: Optional[dict] = None):
        if not model.supports_paged():
            raise NotImplementedError(
                f"{model.cfg.name}: continuous batching needs a GQA "
                f"decoder (no MLA / modality frontend)")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        if faults is not None and any(f.site == "kernel_fail"
                                      for f in faults.faults):
            raise ValueError(KERNEL_FAIL_REFUSED)
        if prefix_cache and any_fp_kv(model.cfg) \
                and model.cfg.attn_impl == "flash":
            raise ValueError(
                "prefix_cache over an fp KV pool needs attn_impl='dense': "
                "at 'flash' the cold prefill attends through the flash "
                "kernel and the suffix prefill densely, so the tokens "
                "could differ from prefix_cache=False")
        self.model = model
        self.params = params
        self.device = model.device
        _shard_init(self, rules)
        # this rank's slots [s0, s0 + sl): a run of them under the
        # kv_batch axes where those divide the slots, else every slot
        rows = _split_rows(self, max_slots)
        self._s0, self._sl = rows.start, rows.stop - rows.start
        self._slots_split = self._sl != max_slots
        if self._slots_split and (prefix_cache or preempt
                                      or faults is not None):
            raise ValueError(SHARDED_SLOTS_REFUSED)
        pool_parts = 1
        if self._sl != max_slots and rules.get("kv_pages"):
            pool_parts = max_slots // self._sl
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
            # (one per run of a pool sharded over the data ranks)
            num_pages = pool_parts \
                + max_slots * self.max_pages_per_slot
        elif pool_parts > 1:
            raise ValueError("a page pool sharded over the data axes is "
                             "sized for full occupancy: leave num_pages "
                             "at its default")
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.tracer = tracer
        self.obs_interval = int(obs_interval)
        self.blocks = BlockManager(num_pages, page_size, max_slots,
                                   self.max_pages_per_slot,
                                   metrics=self.metrics,
                                   partitions=pool_parts)
        self._pool_part = self._s0 // self._sl if pool_parts > 1 else 0
        self.prefix = PrefixCache(self.blocks, metrics=self.metrics) \
            if prefix_cache else None
        self.scheduler = Scheduler(max_slots, self.blocks,
                                   prefix=self.prefix, metrics=self.metrics)
        self.preempt = bool(preempt)
        self.faults = faults
        self.swap_store = HostSwapStore(metrics=self.metrics)
        if faults is not None:
            # alloc_fail fires through the block manager's grant hook (only
            # non-trivial ensure() grants consult it: admission's reserved
            # allocations stay exact), swap_corrupt through the store's put
            self.blocks.fault_hook = (
                lambda n: faults.should_fire("alloc_fail") is not None)
            self.swap_store.faults = faults
        with self._ctx():
            self.pool = model.init_paged_cache(num_pages // pool_parts,
                                               page_size)
        self.vocab = model.cfg.vocab
        self._next_rid = 0
        self._cur_tok = np.zeros(max_slots, np.int32)
        self._lengths = np.zeros(max_slots, np.int32)
        self._remaining = np.zeros(max_slots, np.int32)
        self._bt_version = -1
        self._step_progress = False     # quarantine/swap counts as progress
        self.quarantined_in_step: List[Request] = []
        self._stall_abort = threading.Event()
        self.stall_aborted = False      # the watchdog cut a stalled step
        # requests finished before this index of scheduler.finished predate
        # the last reset_metrics and are left out of finished_in_window
        self._metrics_start = 0
        # the decode window's buffers and its captured step (on the card:
        # one CUDA graph, captured here on all-idle slots)
        with self._ctx():
            self.window = PagedDecodeGraph(
                model, params, self.pool, slots=self._sl,
                max_pages=self.max_pages_per_slot,
                max_window=self.sync_every, temperature=gen.temperature,
                health=self.health_checks, trash_page=TRASH_PAGE,
                capture=self.captures)
        m = self.metrics
        self._c_steps = m.counter(
            "engine.steps", "device decode steps (incl. masked tail)")
        self._c_syncs = m.counter(
            "engine.syncs", "host sync points (decode windows run)")
        self._c_generated = m.counter(
            "engine.generated_tokens", "tokens emitted to requests")
        self._c_prefill_batches = m.counter(
            "engine.prefill_batches", "bucket prefill calls")
        # prefill calls this rank ran: every one without a mesh, only
        # those holding its slots' requests where the slots split over
        # data ranks
        self.n_rank_prefills = 0
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
        self._c_preempt = m.counter(
            "engine.preemptions", "requests swapped out to host")
        self._c_restores = m.counter(
            "engine.restores", "swapped requests restored to a slot")
        self._g_peak_mapped = m.gauge(
            "pages.peak_mapped", "peak distinct pages in slot tables")
        self._g_peak_shared = m.gauge(
            "pages.peak_shared", "peak pages mapped by >= 2 entries")
        self._c_phase = m.counter(
            "engine.phase_s", "wall seconds by engine phase")
        for k in self._PHASES:
            self._c_phase.inc(0.0, phase=k)
        self._h_window = m.histogram(
            "engine.window_steps", "decode steps per sync window")

    # ------------------------------------------------------------ counters
    n_steps = _series("_c_steps")
    n_syncs = _series("_c_syncs")
    n_generated = _series("_c_generated")
    n_prefill_batches = _series("_c_prefill_batches")
    n_hit_batches = _series("_c_hit_batches")
    n_quarantined = _series("_c_quar")
    # prompt positions prefilled (unpadded): a hit counts only its suffix
    prefill_tokens_computed = _series("_c_prefill_tokens")
    n_cow_forks = _series("_c_cow")
    n_preemptions = _series("_c_preempt")
    n_restores = _series("_c_restores")
    peak_mapped_pages = _series("_g_peak_mapped")
    peak_shared_pages = _series("_g_peak_shared")

    @property
    def phase(self) -> Dict[str, float]:
        """Per-phase wall clock (seconds; each phase ends in a host sync)."""
        return {k: float(self._c_phase.value(phase=k))
                for k in self._PHASES}

    @phase.setter
    def phase(self, d: Dict[str, float]) -> None:
        for k in self._PHASES:
            self._c_phase.set(float(d.get(k, 0.0)), phase=k)

    def _phase_add(self, k: str, dt: float) -> None:
        self._c_phase.inc(max(0.0, dt), phase=k)

    @property
    def kv_pool_nbytes(self) -> int:
        """Allocated page-pool bytes, summed over layers."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.pool.values()))

    @property
    def kv_pool_layer_nbytes(self) -> List[int]:
        """Allocated page-pool bytes of each layer: under a per-layer
        table each layer's pages are sized by its own KV specs."""
        out = [0] * self.model.cfg.n_layers
        for g in kv_groups(self.model.cfg):
            leaves = group_leaves(self.pool, g).values()
            per_layer = sum(t[0].numel() * t.element_size() for t in leaves)
            for i in g.layers:
                out[i] = int(per_layer)
        return out

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

    @property
    def finished_in_window(self) -> List[Request]:
        """Requests finished since the last ``reset_metrics``: the
        population latency summaries draw from, so a warm-up request's
        samples cannot leak into a measurement window."""
        return self.scheduler.finished[self._metrics_start:]

    def reset_metrics(self) -> None:
        """Start a measurement window: zero every series of the shared
        registry (engine, scheduler, block manager, prefix cache, swap
        store) and the latency window.  The trie, the pool, the swap
        store's residents and the captured graph stay as they are."""
        self.metrics.reset()
        self._metrics_start = len(self.scheduler.finished)
        self.swap_store.reset_counters()

    # ------------------------------------------------------------ requests
    def add_request(self, prompt, max_new_tokens: int, *,
                    priority: int = 0, deadline_s: Optional[float] = None,
                    arrival_t: Optional[float] = None) -> int:
        """Queue a prompt; returns the request id.  Admission happens in a
        later ``step()``, in (priority, deadline, arrival) order:
        ``priority`` 0 is the most urgent class, ``deadline_s`` an
        optional TTFT target (EDF order within the class, and SLO
        attainment).  ``arrival_t`` (a ``time.perf_counter`` stamp)
        defaults to now; the async front end passes the submission's
        stamp so queueing counts against TTFT.  Raises ValueError when the
        sequence can never fit a slot or the pool."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always "
                             "emits the first generated token)")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, priority=priority,
                      deadline_s=deadline_s,
                      arrival_t=(time.perf_counter() if arrival_t is None
                                 else arrival_t))
        self.scheduler.submit(req)
        self._next_rid += 1
        if self.tracer is not None:
            self.tracer.begin("request", cat="request", rid=req.rid,
                              ts=req.arrival_t,
                              prompt_len=int(req.prompt_len),
                              max_new_tokens=int(max_new_tokens),
                              priority=int(priority))
            self.tracer.begin("queued", cat="request", rid=req.rid,
                              ts=req.arrival_t)
        return req.rid

    def _reopen_track(self, req: Request) -> None:
        """Open the per-request root span again on a track a snapshot
        restore's reconciliation closed."""
        self.tracer.begin("request", cat="request", rid=req.rid,
                          prompt_len=int(req.prompt_len),
                          max_new_tokens=int(req.max_new_tokens),
                          priority=int(req.priority))

    def retry_request(self, req: Request) -> None:
        """Re-queue a quarantined request for another attempt (the engine
        half of the front end's retry budget).  It keeps its rid, so its
        sampling stream restarts and a healthy replay is token-identical
        at any temperature."""
        self.scheduler.requeue(req)
        if self.tracer is not None:
            if not self.tracer.open_spans(req.rid):
                self._reopen_track(req)
            self.tracer.instant("retry", cat="request", rid=req.rid,
                                attempt=int(req.n_retries))
            self.tracer.begin("queued", cat="request", rid=req.rid)

    def resubmit(self, req: Request) -> None:
        """Re-enter a request the engine no longer tracks (one submitted
        after a snapshot that was restored): reset its generation state
        and queue it as if new, keeping its rid."""
        req.state = RequestState.WAITING
        req.slot = -1
        req.out = []
        req.t_tokens = []
        req.t_finished = None
        req.error = None
        req.matched_tokens = 0
        req.cow_pending = 0
        req.swap_pages = 0
        self.scheduler.submit(req)
        if self.tracer is not None:
            if not self.tracer.open_spans(req.rid):
                self._reopen_track(req)
            else:
                self.tracer.unwind(req.rid, keep=1)
            self.tracer.instant("resubmit", cat="request", rid=req.rid)
            self.tracer.begin("queued", cat="request", rid=req.rid)

    def abort_stall(self) -> None:
        """Cut a faulted ``stall`` wait short (safe from the watchdog's
        thread)."""
        self._stall_abort.set()

    def step(self) -> List[Tuple[int, int]]:
        """One host sync cycle: swap victims out (with ``preempt``), admit
        what fits (restores, then bucket-batched prefill), run one decode
        window of up to ``sync_every`` device steps; returns the (request
        id, token) pairs emitted, in step order.  A slot whose health
        guard trips is quarantined instead of emitting
        (``quarantined_in_step`` lists this cycle's); a failed page grant
        swaps the starved slot out, to resume later."""
        emitted: List[Tuple[int, int]] = []
        self.quarantined_in_step = []
        self._step_progress = False
        if self.faults is not None:
            self._consult_step_faults()
            if self.stall_aborted:
                return emitted          # the watchdog cut the stall short
        if self.preempt:
            # one victim at a time until the waiting head fits or no
            # strictly lower-priority runner remains; admit() below
            # grants the freed slot and pages
            while (victim := self.scheduler.pick_victim()) is not None:
                self._swap_out(victim)
        t0 = time.perf_counter()
        admitted = self.scheduler.admit()
        t_adm = time.perf_counter()
        self._phase_add("sync", t_adm - t0)
        if self.tracer is not None:
            for r in admitted:
                # re-admissions (restore, retry) opened "queued" again; a
                # track without it was reconciled by a snapshot restore
                if self.tracer.top(r.rid) == "queued":
                    self.tracer.end("queued", cat="request", rid=r.rid,
                                    ts=t_adm)
                self.tracer.instant(
                    "admitted", cat="request", rid=r.rid, ts=t_adm,
                    slot=int(r.slot), matched_tokens=int(r.matched_tokens),
                    restored=r.rid in self.swap_store)
        if admitted:
            self._batched_prefill(admitted, emitted)
        t0 = time.perf_counter()
        if not self.scheduler.running:
            self._phase_add("sync", time.perf_counter() - t0)
            return emitted
        try:
            window = self.scheduler.plan_window(self._lengths,
                                                self.sync_every)
        except PageGrantError as e:
            # a grant failed although admission reserved the pages (an
            # allocator fault): swap the starved slot out instead of
            # failing the window; it resumes at its original rank
            self._swap_out(self.scheduler.running[e.slot])
            self._phase_add("sync", time.perf_counter() - t0)
            return emitted
        self._note_page_stats()             # post-grant working set
        snapshot = sorted(self.scheduler.running.items())
        rem0 = {slot: req.remaining for slot, req in snapshot}
        w = self.window
        self._upload_tables()
        t1 = time.perf_counter()
        mine = slice(self._s0, self._s0 + self._sl)
        w.state.copy_(torch.from_numpy(np.stack(
            [self._cur_tok[mine], self._lengths[mine],
             self._remaining[mine]])))
        with self._ctx():
            w.run(window)
        sl = self._sl
        flags = [w.tokens[:window].reshape(-1), w.bad.to(torch.int32)]
        if self.health_checks and any_mx_kv(self.model.cfg):
            # lengths after the window: every position a slot wrote
            flags.append(slot_scale_poison(self.pool, w.block_tables,
                                           w.state[1], self.model.cfg)
                         .to(torch.int32))
        else:
            flags.append(torch.zeros(sl, dtype=torch.int32,
                                     device=self.device))
        host = torch.cat(flags).cpu().numpy()   # the one transfer per window
        toks, badl, poison = self._merge_window(
            host[:window * sl].reshape(window, sl),
            host[window * sl:(window + 1) * sl],
            host[(window + 1) * sl:])
        t2 = time.perf_counter()
        self._c_steps.inc(window)
        self._c_syncs.inc()
        self._h_window.observe(window)
        if self.tracer is not None:
            # both spans reuse the window's two stamps: the tracer adds no
            # synchronize and no transfer of its own
            self.tracer.span("decode_window", t0=t1, t1=t2,
                             steps=int(window), live=len(snapshot))
            for slot, req in snapshot:
                self.tracer.span(
                    "decode", cat="request", rid=req.rid, t0=t1, t1=t2,
                    steps=int(min(window, rem0[slot])), slot=int(slot))
        if self.obs_interval and self.n_syncs % self.obs_interval == 0:
            self._sample_mx_health()
        for t in range(window):
            for slot, req in snapshot:
                if badl[slot] or poison[slot]:
                    continue            # quarantined below; no tokens out
                if t < rem0[slot]:
                    tok = int(toks[t, slot])
                    req.out.append(tok)
                    # a window's tokens become visible together, at its
                    # one host transfer
                    req.t_tokens.append(t2)
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

    def _consult_step_faults(self) -> None:
        """Step-scoped fault sites, in the reference's order: ``stall``
        waits (cooperatively: ``abort_stall`` cuts it short, as the front
        end's watchdog does before it restores a snapshot);
        ``page_corrupt`` writes SCALE_NAN markers into one live KV
        position's scale bytes in every layer (NaN into an fp pool) —
        what a faulty converter or DMA would leave behind — in place, in
        the pool the captured graph reads."""
        plan = self.faults
        self.stall_aborted = False
        f = plan.should_fire("stall")
        if f is not None:
            if self.tracer is not None:
                self.tracer.instant("fault:stall", stall_s=f.stall_s)
            deadline = time.monotonic() + f.stall_s
            while time.monotonic() < deadline:
                if self._stall_abort.is_set():
                    self._stall_abort.clear()
                    self.stall_aborted = True
                    return
                time.sleep(0.002)
        f = plan.should_fire("page_corrupt")
        if f is not None and self.scheduler.running:
            cands = sorted(self.scheduler.running.items())
            if f.rid is not None:
                cands = [(s, r) for s, r in cands if r.rid == f.rid]
            if cands:
                rng = plan.rng("page_corrupt")
                slot, _ = cands[int(rng.integers(len(cands)))]
                length = int(self._lengths[slot])
                if length > 0:
                    pos = int(rng.integers(length))
                    pid = self.blocks.slot_page_ids(slot)[
                        pos // self.page_size]
                    F.poison_pool_pages(self.pool, [pid],
                                        offset=pos % self.page_size)
                    if self.tracer is not None:
                        self.tracer.instant("fault:page_corrupt",
                                            page=int(pid), pos=pos)

    # ------------------------------------------------------------ internals
    def _local_tables(self, tables: np.ndarray) -> np.ndarray:
        """Block-table rows as this rank's pool holds their pages."""
        return self.blocks.local_pages(tables, self._pool_part)

    def _upload_tables(self) -> None:
        """Copy this rank's rows of the host block table into the captured
        step's buffer, only when the host tables changed (admission /
        page grant / eviction)."""
        if self._bt_version != self.blocks.version:
            rows = self.blocks.tables[self._s0:self._s0 + self._sl]
            self.window.block_tables.copy_(
                torch.from_numpy(self._local_tables(rows)))
            self._bt_version = self.blocks.version

    def _slot_data(self):
        """(ranks, axes) the slots split over: the kv_batch axes, or none
        where every rank runs every slot."""
        if self._slots_split:
            return self._n_data, self._data_axes
        return 1, ()

    def _local_slots(self, reqs: List[Request]) -> List[int]:
        """Indices into ``reqs`` of the requests in this rank's slots."""
        return [i for i, r in enumerate(reqs)
                if self._s0 <= r.slot < self._s0 + self._sl]

    def _merge_window(self, toks, bad, poison):
        """Every slot's window tokens (window, slots) and health flags
        from this rank's (window, sl) / (sl,): the data ranks' slots side
        by side, and a flag raised by any "model" rank (each scans its
        own KV heads) raised for all."""
        if self.mesh is None:
            return toks, bad != 0, poison != 0
        w = toks.shape[0]
        local = np.concatenate([toks.reshape(-1), bad, poison])
        nd, data = self._slot_data()
        allr = self.mesh.host_gather(local, data + self._model_axes)
        allr = allr.reshape(nd, -1, local.size)
        flags = allr[:, :, w * self._sl:].max(axis=1)
        toks = allr[:, 0, :w * self._sl].reshape(nd, w, self._sl)
        toks = toks.transpose(1, 0, 2).reshape(w, -1)
        flags = flags.reshape(nd, 2, self._sl)
        return (toks, flags[:, 0].reshape(-1) != 0,
                flags[:, 1].reshape(-1) != 0)

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
            if any_mx_kv(self.model.cfg):
                bad |= slot_scale_poison(self.pool, tables, lens,
                                         self.model.cfg)
            out.append(bad.to(torch.int32))
        host = torch.cat(out).cpu().numpy()
        bad = host[g:] != 0 if self.health_checks else np.zeros(g, bool)
        return host[:g], keys, bad

    def _prefill_scatter(self, tokens: np.ndarray, lens: np.ndarray,
                         rids: List[int], page_ids: np.ndarray):
        """Prefill one bucket of G same-padded prompts, scatter every
        request's pages into the pool (packing sub-byte codes) and sample
        each request's first token from its last prompt position."""
        dev = self.device
        g = tokens.shape[0]
        self.n_rank_prefills += 1
        with self._ctx():
            logits, cache, _ = self.model.prefill(
                self.params, torch.from_numpy(tokens).to(dev),
                max_len=tokens.shape[1])
            pids = torch.from_numpy(self._local_tables(page_ids)).to(dev)
            self.model.scatter_prefill(self.pool, cache, pids)
        lens_d = torch.from_numpy(lens).to(dev)
        last = logits[torch.arange(g, device=dev),
                      lens_d.to(torch.int64) - 1, :self.vocab]
        return self._first_tokens(last, rids, pids, lens_d)

    def _prefill_bucket(self, reqs: List[Request], tokens: np.ndarray,
                        lens: np.ndarray, page_ids: np.ndarray):
        """``_prefill_scatter`` of the bucket's requests in this rank's
        slots, installing their keys; returns every request's (first
        token, health flag), gathered over the mesh: each data rank
        prefills its own slots' requests, and a flag raised by any
        "model" rank counts for all."""
        mine = self._local_slots(reqs)
        g = len(reqs)
        first = np.zeros(g, np.int64)
        bad = np.zeros(g, np.int64)
        if mine:
            f, keys, b = self._prefill_scatter(
                tokens[mine], lens[mine], [reqs[i].rid for i in mine],
                page_ids[mine])
            slots = [reqs[i].slot - self._s0 for i in mine]
            self.window.keys[torch.tensor(slots, device=self.device)] = keys
            first[mine], bad[mine] = f, b
        if self.mesh is None:
            return first, bad != 0
        nd, data = self._slot_data()
        allr = self.mesh.host_gather(
            np.concatenate([first, bad]),
            data + self._model_axes).reshape(nd, -1, 2 * g)
        # a request's values come from its one data rank (zeros elsewhere)
        first = allr[:, 0, :g].sum(axis=0)
        bad = allr[:, :, g:].max(axis=1).max(axis=0)
        return first, bad != 0

    def _batched_prefill(self, admitted: List[Request],
                         emitted: List[Tuple[int, int]]) -> None:
        """Prefill admissions bucket by bucket.  Cold admissions (no
        cached prefix) pad to the bucket and prefill as one batch whose
        pages scatter in one pass.  Prefix-cache hits take the suffix
        path: the copy-on-write forks they owe run first (one batched
        page copy), then each bucket of same-padded *suffix* lengths
        prefills only its uncached positions through the paged pool.
        Restored requests (preempted earlier) take no prefill: their pages
        come back from the swap store."""
        restored = [r for r in admitted if r.rid in self.swap_store]
        if restored:
            self._restore_swapped(restored)
            rids = {r.rid for r in restored}
            admitted = [r for r in admitted if r.rid not in rids]
        if not admitted:
            return
        t0 = time.perf_counter()
        cold = [r for r in admitted if r.matched_tokens == 0]
        hits = [r for r in admitted if r.matched_tokens > 0]
        if self.tracer is not None:
            # an open pair, not a span from two stamps: a first-decode
            # page grant can swap a request out inside _finish_prefill,
            # and that swap_out span must nest inside this one
            self.tracer.begin("prefill_batch", ts=t0, cold=len(cold),
                              hits=len(hits))
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
            tb = time.perf_counter()
            first, bad = self._prefill_bucket(reqs, toks, lens, page_ids)
            self._c_prefill_batches.inc()
            self._finish_prefill(reqs, first, bad, emitted, tb)
        if hits:
            self._cow_forks(hits)
            self._hit_prefill(hits, emitted)
        self._note_page_stats()
        t1 = time.perf_counter()
        self._phase_add("prefill", t1 - t0)
        if self.tracer is not None:
            self.tracer.end("prefill_batch", ts=t1)

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
            tb = time.perf_counter()
            starts_d = torch.from_numpy(starts).to(dev)
            lens_d = torch.from_numpy(lens).to(dev)
            with self._ctx():
                logits, _ = self.model.paged_prefill_suffix(
                    self.params, torch.from_numpy(toks).to(dev), starts_d,
                    lens_d, self.pool, bt)
            last = logits[torch.arange(g, device=dev),
                          (lens_d - starts_d).to(torch.int64) - 1,
                          :self.vocab]
            first, keys, bad = self._first_tokens(
                last, [r.rid for r in reqs], bt, lens_d)
            if self.mesh is not None:   # a flag of any "model" rank
                bad = self.mesh.host_gather(
                    bad.astype(np.int64), self._model_axes).max(axis=0) != 0
            self.window.keys[slots] = keys
            self._c_prefill_batches.inc()
            self._c_hit_batches.inc()
            self.n_rank_prefills += 1
            self._finish_prefill(reqs, first, bad, emitted, tb)

    def _finish_prefill(self, reqs: List[Request], first: np.ndarray,
                        bad: np.ndarray, emitted: List[Tuple[int, int]],
                        t0: float) -> None:
        """Admission epilogue (the keys are installed): emit each request's
        first token, stamped now (after its host transfer: TTFT), account
        its prefilled positions and grant the first decode write's page;
        a flagged request — or one whose ``prefill_nan`` fault fires here
        — is quarantined instead, and a failed grant (``alloc_fail``)
        swaps the request out to resume later.  ``t0`` is the bucket's
        stamp before its prefill: a tracer records each request's
        "prefill" span from it to now."""
        now = time.perf_counter()
        if self.tracer is not None:
            for r in reqs:
                self.tracer.span(
                    "prefill", cat="request", rid=r.rid, t0=t0, t1=now,
                    tokens=int(r.prompt_len - r.prefill_start),
                    suffix=bool(r.prefill_start))
        for i, r in enumerate(reqs):
            self._c_prefill_tokens.inc(r.prompt_len - r.prefill_start)
            if self.faults is not None and self.faults.should_fire(
                    "prefill_nan", rid=r.rid) is not None:
                # poison exactly the pages holding the prompt's KV: the
                # padded tail of the row may alias the trash page, which
                # every slot reads
                n_live = pages_needed(r.prompt_len, self.page_size)
                F.poison_pool_pages(
                    self.pool, self.blocks.slot_page_ids(r.slot)[:n_live])
                bad[i] = True
            if bad[i]:
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
            r.t_tokens.append(now)
            self._c_generated.inc()
            emitted.append((r.rid, tok))
            if r.done:
                self._release(r)
            elif not self.blocks.ensure(slot, r.prompt_len + 1):
                # the first decode write may sit in a page past the
                # prompt's allocation; admission reserved it, so only an
                # allocator fault fails the grant: park the request in the
                # swap store to resume later
                self._swap_out(r)

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
        F.scrub_pool_pages(self.pool, dead)
        req.t_finished = time.perf_counter()
        self._c_quar.inc()
        if self.tracer is not None:
            # leave only the per-request root open: the front end either
            # retries (opening "queued" again) or closes the track with a
            # terminal status once the retry budget is spent
            self.tracer.unwind(req.rid, ts=req.t_finished, keep=1)
            self.tracer.instant("quarantine", cat="request", rid=req.rid,
                                ts=req.t_finished, error=diag)
        self.quarantined_in_step.append(req)
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
        req.t_finished = time.perf_counter()
        if self.tracer is not None:
            self.tracer.unwind(req.rid, ts=req.t_finished, keep=1)
            self.tracer.close_track(req.rid, ts=req.t_finished,
                                    status="finished", tokens=len(req.out))
        self._cur_tok[slot] = 0
        self._lengths[slot] = 0
        self._remaining[slot] = 0

    # ---------------------------------------------------- preempt-and-swap
    def _swap_out(self, req: Request) -> None:
        """Copy ``req``'s KV pages (MX codes still packed) and its sampling
        key to the host swap store, one synchronize for the lot, and free
        its slot: the device half of ``Scheduler.preempt``.  The key and
        the request's own token history make the later restore
        token-identical."""
        t0 = time.perf_counter()
        slot = req.slot
        ids = self.blocks.slot_page_ids(slot)
        key = to_host(self.window.keys[slot])
        pages, nbytes = gather_pages(self.pool, ids)   # synchronizes
        self.swap_store.put(req.rid, SwapData(
            pages=pages, n_pages=len(ids), length=int(self._lengths[slot]),
            key=key, nbytes=nbytes))
        req.swap_pages = len(ids)
        self.scheduler.preempt(req)
        self._c_preempt.inc()
        self._step_progress = True
        self._cur_tok[slot] = 0
        self._lengths[slot] = 0
        self._remaining[slot] = 0
        t1 = time.perf_counter()
        self._phase_add("swap", t1 - t0)
        if self.tracer is not None:
            self.tracer.span("swap_out", t0=t0, t1=t1, pages=len(ids),
                             nbytes=nbytes)
            self.tracer.instant("preempt", cat="request", rid=req.rid,
                                ts=t1, pages=len(ids))
            self.tracer.begin("queued", cat="request", rid=req.rid, ts=t1)

    def _restore_swapped(self, reqs: List[Request]) -> None:
        """Re-admission of preempted requests: write their saved pages into
        the freshly allocated private pages (one scatter per pool leaf for
        all restores of this cycle, in place: the captured graph reads
        these leaves) and rebuild each slot's state — current token, cache
        length, budget and sampling key as saved.  No prefill runs and no
        token is emitted (the first token streamed before the
        preemption)."""
        t0 = time.perf_counter()
        ids: List[int] = []
        datas = []
        for r in reqs:
            data = self.swap_store.pop(r.rid)
            slot_ids = self.blocks.slot_page_ids(r.slot)
            assert len(slot_ids) == data.n_pages, \
                "restore admission allocated the swapped page count"
            ids.extend(slot_ids)
            datas.append(data)
        scatter_pages(self.pool, ids,
                      concat_snapshots([d.pages for d in datas]))
        slots = torch.tensor([r.slot for r in reqs], device=self.device)
        self.window.keys.index_copy_(0, slots, torch.stack(
            [d.key for d in datas]).to(self.device, non_blocking=True))
        for r, data in zip(reqs, datas):
            # out[-1] is the last sampled token, not yet fed back; the
            # cache holds prompt + out[:-1] = data.length positions
            self._cur_tok[r.slot] = r.out[-1]
            self._lengths[r.slot] = data.length
            self._remaining[r.slot] = r.max_new_tokens - len(r.out)
            r.swap_pages = 0
            self._c_restores.inc()
        self._note_page_stats()
        sync(self.device)               # the swap phase ends on the host
        t1 = time.perf_counter()
        self._phase_add("swap", t1 - t0)
        if self.tracer is not None:
            self.tracer.span("swap_restore", t0=t0, t1=t1,
                             requests=len(reqs), pages=len(ids))
            for r, data in zip(reqs, datas):
                self.tracer.span("restore", cat="request", rid=r.rid,
                                 t0=t0, t1=t1, pages=data.n_pages,
                                 slot=int(r.slot))

    # ---------------------------------------------------- MX-health gauges
    def _sample_mx_health(self) -> None:
        """One device reduction over the live KV pages, read back in one
        host transfer, published as the ``mx.*`` gauges per KV role:
        scale bytes scanned, poison markers, and the shared-scale
        saturation (== block clip under a shared scale) and underflow
        rates.  Runs after the window's host transfer, on the same
        stream, outside the captured graph; the lengths are those the
        window started from, as in the reference."""
        stats = sample_mx_health(
            self.pool, self.window.block_tables,
            torch.from_numpy(self._lengths[self._s0:self._s0 + self._sl]),
            self.model.cfg)
        m = self.metrics
        for role, st in stats.items():
            nb = st["scale_bytes"]
            m.gauge("mx.scale_bytes",
                    "E8M0 scale bytes in live KV pages").set(nb, role=role)
            m.gauge("mx.poison_markers",
                    "scale bytes at/above the mode's poison threshold"
                    ).set(st["poison"], role=role)
            m.gauge("mx.saturation_rate",
                    "fraction of blocks at the max legal shared scale"
                    ).set(rate(st["saturated"], nb), role=role)
            m.gauge("mx.clip_rate",
                    "fraction of blocks clipping elements (== the "
                    "saturation rate: a shared scale at top-of-range is "
                    "exactly the block-clip indicator)"
                    ).set(rate(st["saturated"], nb), role=role)
            m.gauge("mx.underflow_rate",
                    "fraction of blocks with a zero shared scale"
                    ).set(rate(st["underflow"], nb), role=role)

    def finalize_trace(self) -> None:
        """Close every request track still open (queued, swapped-out, or
        failed-without-retry requests at shutdown) so the exported trace
        validates: failed requests close with status "failed", the rest
        "aborted".  Idempotent; the launcher calls it before writing the
        trace files."""
        if self.tracer is None:
            return
        failed = {r.rid for r in self.scheduler.failed}
        for rid in self.tracer.open_tracks():
            if rid is None:
                continue
            self.tracer.close_track(
                rid, status="failed" if rid in failed else "aborted")
        self.tracer.close_track(None)
