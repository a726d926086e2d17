"""Asyncio serving front end over ``ContinuousBatchingEngine`` (mirrors
src/repro/serve/frontend.py).

``AsyncServer`` accepts requests as they arrive (coroutines calling
:meth:`AsyncServer.submit`), streams each request's tokens back through
its own ``asyncio.Queue``, and drives the engine from a **single
background step loop**: the engine stays synchronous, so its token
identity carries over unchanged.

Concurrency model:

* Submissions land in a pending deque; the step loop applies them to the
  scheduler *between* engine steps, always on the loop task, so the
  scheduler is never touched while a step runs — also when the step
  runs in a worker thread (``use_executor=True``).
* Each accepted request gets a :class:`RequestStream`; the step loop
  pushes ``(token, final)`` pairs into its queue as ``engine.step()``
  emits them, and the caller consumes them with ``async for``.
* Backpressure: ``max_queued`` bounds the requests waiting for
  admission; ``submit`` waits (``admission="block"``) until the backlog
  drains, or raises :class:`RejectedError` (``admission="reject"``) when
  the request could not start at once — the reject-on-full baseline
  preempt-and-swap is measured against.
* ``use_executor=True`` runs each engine step in the default thread-pool
  executor, so the event loop stays responsive while the host waits on
  the card.  CUDA's current device is per thread, so the worker enters
  the engine's device first; the step and the loop thread's copies
  (snapshot capture) go to the device's default stream, which orders
  them.  One caller steps the engine at a time.

Latency is carried by the ``Request`` objects (``arrival_t`` stamped at
submission, token stamps by the engine); :func:`latency_summary`
aggregates a population of finished requests into p50/p99 TTFT and ITL
and SLO attainment.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import time
from typing import AsyncIterator, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry, percentile
from repro_torch.serve import snapshot as snapshot_mod
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.scheduler import Request, RequestState


class RejectedError(RuntimeError):
    """Raised by ``submit`` under ``admission="reject"`` when the request
    cannot start at once (no free slot or pages, or a backlog exists)."""


class QuarantinedError(RuntimeError):
    """A request was quarantined by a numeric-health guard and no retry
    budget remains (``retries=0``).  Raised out of the request's stream;
    the message carries the engine's diagnostic."""


class RetriesExhausted(QuarantinedError):
    """A quarantined request failed every attempt of its retry budget."""


def latency_summary(finished: Sequence[Request]) -> Dict[str, float]:
    """p50/p99 TTFT and ITL (milliseconds) and SLO attainment over a
    population of finished requests; requests without stamps are
    skipped."""
    ttft = [r.ttft_s for r in finished if r.ttft_s is not None]
    itl: List[float] = []
    for r in finished:
        itl.extend(r.itl_s)
    out: Dict[str, float] = {"n_requests": float(len(finished))}
    if ttft:
        out["ttft_p50_ms"] = percentile(ttft, 50) * 1e3
        out["ttft_p99_ms"] = percentile(ttft, 99) * 1e3
    if itl:
        out["itl_p50_ms"] = percentile(itl, 50) * 1e3
        out["itl_p99_ms"] = percentile(itl, 99) * 1e3
    met = [r.deadline_met for r in finished if r.deadline_met is not None]
    if met:
        out["slo_attainment"] = sum(met) / len(met)
    return out


class RequestStream:
    """One request's token stream: ``async for tok in stream`` yields the
    generated token ids as the engine emits them; :meth:`tokens` collects
    the whole output.  ``request`` is the live ``Request`` (latency
    stamps, preemption count)."""

    def __init__(self, rid: int, request: Request):
        self.rid = rid
        self.request = request
        self._q: asyncio.Queue = asyncio.Queue()
        self._out: List[int] = []
        self._done = False
        # tokens the server put into the queue: what a replay after a
        # retry skips
        self.n_pushed = 0

    def __aiter__(self) -> AsyncIterator[int]:
        return self._gen()

    async def _gen(self) -> AsyncIterator[int]:
        # once the final token is consumed the stream is exhausted:
        # iterating again must stop, not wait on an empty queue
        while not self._done:
            item = await self._q.get()
            if isinstance(item, Exception):
                self._done = True       # QuarantinedError / RetriesExhausted
                raise item
            tok, final = item
            self._out.append(tok)
            self._done = final
            yield tok

    async def tokens(self) -> np.ndarray:
        """Drain the stream; returns every generated token (including any
        consumed earlier through ``async for``)."""
        async for _ in self:
            pass
        return np.asarray(self._out, np.int32)


class _Pending:
    """One submission waiting for the step loop to apply it."""

    __slots__ = ("future", "prompt", "max_new_tokens", "priority",
                 "deadline_s", "arrival_t")

    def __init__(self, future, prompt, max_new_tokens, priority, deadline_s,
                 arrival_t):
        self.future = future
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.deadline_s = deadline_s
        self.arrival_t = arrival_t


class AsyncServer:
    """Single-loop asyncio front end over a ``ContinuousBatchingEngine``.

    ``admission``      — ``"block"`` queues submissions (waiting while
                         ``max_queued`` are waiting for admission);
                         ``"reject"`` raises :class:`RejectedError` unless
                         the request can start at once.
    ``use_executor``   — run each engine step in the default thread-pool
                         executor (in the engine's device context).
    ``retries``        — per-request retry budget for quarantined
                         requests: one re-enters the queue after a jittered
                         exponential backoff (``retry_backoff_s *
                         2**attempt``) under its rid, so the replay is
                         token-identical, and tokens its stream already
                         delivered are skipped.  After ``retries`` failed
                         attempts the stream raises
                         :class:`RetriesExhausted` (``retries=0`` raises
                         :class:`QuarantinedError` at once).
    ``watchdog_s``     — stalled-step watchdog (needs
                         ``use_executor=True``): when one engine step
                         runs longer than this, the server aborts the
                         stall cooperatively (``engine.abort_stall``),
                         waits for the aborted step to return, and only
                         then restores the last snapshot in place; streams
                         resume token-identically (tokens already
                         delivered are skipped on replay).
                         ``server.recoveries`` counts the restores.  It
                         must comfortably exceed the slowest healthy step,
                         or a slow step trips a (sound, token-identical,
                         wasteful) recovery.
    ``snapshot_every`` — take an engine snapshot (``serve.snapshot``)
                         every N completed steps; one is taken at start
                         when this or ``watchdog_s`` is set.
                         ``last_snapshot`` holds the latest.

    Use as an async context manager (starts and stops the step loop), or
    call :meth:`start` / :meth:`stop`.
    """

    def __init__(self, engine: ContinuousBatchingEngine, *,
                 admission: str = "block", max_queued: int = 64,
                 use_executor: bool = False, retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 watchdog_s: Optional[float] = None,
                 snapshot_every: Optional[int] = None):
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', "
                             f"got {admission!r}")
        if max_queued < 1:
            raise ValueError(f"max_queued must be >= 1, got {max_queued}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if watchdog_s is not None and not use_executor:
            raise ValueError(
                "watchdog_s requires use_executor=True: without the "
                "executor the step blocks the event loop and a stalled "
                "step could never be timed out")
        if snapshot_every is not None and snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        self.engine = engine
        self.admission = admission
        self.max_queued = int(max_queued)
        self.use_executor = bool(use_executor)
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.snapshot_every = snapshot_every
        self.watchdog_s = watchdog_s
        self.last_snapshot = None           # snapshot.EngineSnapshot
        # tokens each stream had received when last_snapshot was taken
        self._snap_pushed: Dict[int, int] = {}
        self._pending: collections.deque = collections.deque()
        self._requeue: collections.deque = collections.deque()
        self._streams: Dict[int, RequestStream] = {}
        self._skip: Dict[int, int] = {}     # replayed tokens to skip
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._space: Optional[asyncio.Condition] = None
        self._stopping = False
        self._steps_since_snap = 0
        # the server's own registry: engine.reset_metrics() restarts the
        # engine's window without zeroing the server's history
        self.metrics = MetricsRegistry()
        self._c_accepted = self.metrics.counter(
            "server.accepted", "submissions applied to the scheduler")
        self._c_rejected = self.metrics.counter(
            "server.rejected", "admission='reject' turn-aways")
        self._c_retried = self.metrics.counter(
            "server.retried", "retry attempts dispatched")
        self._c_failed = self.metrics.counter(
            "server.failed", "terminal quarantines")
        self._c_recoveries = self.metrics.counter(
            "server.recoveries", "watchdog snapshot restores")

    @property
    def n_accepted(self) -> int:
        return int(self._c_accepted.value())

    @property
    def n_rejected(self) -> int:
        return int(self._c_rejected.value())

    @property
    def n_retried(self) -> int:
        return int(self._c_retried.value())

    @property
    def n_failed(self) -> int:
        return int(self._c_failed.value())

    @property
    def n_recoveries(self) -> int:
        return int(self._c_recoveries.value())

    def obs_snapshot(self) -> Dict[str, object]:
        """One structured view of the serving process: the server's own
        series, the engine registry (engine, scheduler, paging, prefix,
        swap and ``mx.*`` series) and the latency summary over the
        current measurement window; JSON-serializable."""
        return {"server": self.metrics.snapshot(),
                "engine": self.engine.metrics.snapshot(),
                "latency": latency_summary(self.engine.finished_in_window)}

    # ------------------------------------------------------------ lifecycle
    async def __aenter__(self) -> "AsyncServer":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("server already started")
        self._wake = asyncio.Event()
        self._space = asyncio.Condition()
        self._stopping = False
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        """Drain in-flight work, then stop the step loop."""
        try:
            await self.drain()
        finally:
            self._stopping = True
            self._wake.set()
            await self._task
            self._task = None

    # ------------------------------------------------------------ submission
    def _backlog(self) -> int:
        """Requests accepted but not yet admitted into a slot."""
        return len(self._pending) + len(self.engine.scheduler.waiting)

    async def submit(self, prompt, max_new_tokens: int, *,
                     priority: int = 0,
                     deadline_s: Optional[float] = None) -> RequestStream:
        """Accept one request; resolves to its :class:`RequestStream` once
        the step loop has applied it (or raises :class:`RejectedError`
        under ``admission="reject"``).  The arrival stamp is taken here,
        so backlog, queueing and preemption all count against TTFT."""
        if self._task is None:
            raise RuntimeError("server is not running")
        arrival = time.perf_counter()
        if self.admission == "block":
            async with self._space:
                await self._space.wait_for(
                    lambda: self._backlog() < self.max_queued)
        future = asyncio.get_running_loop().create_future()
        self._pending.append(_Pending(
            future, np.asarray(prompt, np.int32).reshape(-1),
            int(max_new_tokens), int(priority), deadline_s, arrival))
        self._wake.set()
        return await future

    async def drain(self) -> None:
        """Wait until every accepted request has finished streaming (or
        failed for good)."""
        while (self._pending or self._requeue or self._streams
               or self.engine.scheduler.has_work()):
            if self._task.done():
                self._task.result()     # the step loop died: raise why
            self._wake.set()
            await asyncio.sleep(0.001)

    # ------------------------------------------------------------ step loop
    def _apply_pending(self) -> None:
        """Apply queued submissions and due retries to the scheduler, on
        the loop task between steps (the scheduler has one writer).
        Retries go first: they keep their original arrival rank."""
        while self._requeue:
            req = self._requeue.popleft()
            if req.state is not RequestState.FAILED:
                continue        # a snapshot restore rewound the failure
            stream = self._streams.get(req.rid)
            if stream is not None:
                # the replay is token-identical: skip what streamed
                self._skip[req.rid] = stream.n_pushed
            self.engine.retry_request(req)
            self._c_retried.inc()
        sched = self.engine.scheduler
        while self._pending:
            p = self._pending.popleft()
            if p.future.cancelled():
                continue
            if self.admission == "reject" and not sched.can_admit_now(
                    p.prompt, p.max_new_tokens):
                self._c_rejected.inc()
                p.future.set_exception(RejectedError(
                    "cannot start immediately: admission='reject'"))
                continue
            try:
                rid = self.engine.add_request(
                    p.prompt, p.max_new_tokens, priority=p.priority,
                    deadline_s=p.deadline_s, arrival_t=p.arrival_t)
            except ValueError as e:        # can never fit a slot or pool
                p.future.set_exception(e)
                continue
            req = next(r for r in sched.waiting if r.rid == rid)
            stream = RequestStream(rid, req)
            self._streams[rid] = stream
            self._c_accepted.inc()
            p.future.set_result(stream)

    def _step_in_worker(self):
        """``engine.step`` in an executor thread, on the engine's device
        (CUDA's current device is per thread)."""
        dev = self.engine.device
        ctx = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        with ctx:
            return self.engine.step()

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        if self.watchdog_s is not None or self.snapshot_every is not None:
            self._take_snapshot()
        while True:
            self._apply_pending()
            if self.engine.scheduler.has_work():
                recovered = False
                if self.use_executor:
                    step = loop.run_in_executor(None, self._step_in_worker)
                    if self.watchdog_s is None:
                        emitted = await step
                    else:
                        try:
                            emitted = await asyncio.wait_for(
                                asyncio.shield(step), self.watchdog_s)
                        except asyncio.TimeoutError:
                            # a stalled step: cut it short, wait until it
                            # has returned (nothing may race the restore),
                            # then roll the engine back to the snapshot;
                            # its work is discarded and replayed
                            self.engine.abort_stall()
                            await step
                            self._recover_from_snapshot()
                            recovered = True
                else:
                    emitted = self.engine.step()
                    await asyncio.sleep(0)  # let submitters interleave
                if not recovered:
                    self._publish(emitted)
                    self._handle_quarantines(loop)
                    self._steps_since_snap += 1
                    if self.snapshot_every is not None \
                            and self._steps_since_snap \
                            >= self.snapshot_every:
                        self._take_snapshot()
            async with self._space:
                self._space.notify_all()
            if not self.engine.scheduler.has_work() \
                    and not self._pending and not self._requeue:
                if self._stopping:
                    return
                self._wake.clear()
                if self._pending or self._requeue:  # raced with a submit
                    continue
                await self._wake.wait()

    def _publish(self, emitted) -> None:
        done = {r.rid for r in self.engine.scheduler.finished}
        last: Dict[int, int] = {}
        for i, (rid, _) in enumerate(emitted):
            last[rid] = i
        for i, (rid, tok) in enumerate(emitted):
            stream = self._streams.get(rid)
            if stream is None:
                continue
            final = rid in done and i == last[rid]
            skip = self._skip.get(rid, 0)
            if skip > 0:
                # a replayed token the stream already delivered (a final
                # token is never among them: delivering it drops the
                # stream)
                self._skip[rid] = skip - 1
                continue
            stream._q.put_nowait((tok, final))
            stream.n_pushed += 1
            if final:
                del self._streams[rid]
                self._skip.pop(rid, None)

    # ------------------------------------------------------------ retries
    def _backoff_delay(self, req: Request) -> float:
        """Exponential backoff with a deterministic per-(rid, attempt)
        jitter in [1.0, 1.25): decorrelates quarantines of one step
        without a random generator."""
        j = ((req.rid * 2654435761 + req.n_retries * 40503) % 997) / 997.0
        return self.retry_backoff_s * (2 ** req.n_retries) * (1 + 0.25 * j)

    def _handle_quarantines(self, loop) -> None:
        """Route this step's quarantined requests: a backed-off retry
        while budget remains, else fail the stream."""
        for req in self.engine.quarantined_in_step:
            if req.n_retries < self.retries:
                loop.call_later(self._backoff_delay(req),
                                self._requeue_later, req)
                continue
            self._c_failed.inc()
            tr = self.engine.tracer
            if tr is not None and tr.open_spans(req.rid):
                # the engine unwound the track to its root at quarantine;
                # a spent retry budget is the terminal close
                tr.close_track(req.rid, status="failed")
            stream = self._streams.pop(req.rid, None)
            self._skip.pop(req.rid, None)
            if stream is None:
                continue
            if self.retries:
                err: Exception = RetriesExhausted(
                    f"request {req.rid} quarantined after "
                    f"{req.n_retries} retries: {req.error}")
            else:
                err = QuarantinedError(
                    f"request {req.rid} quarantined: {req.error}")
            stream._q.put_nowait(err)

    def _requeue_later(self, req: Request) -> None:
        """``call_later`` target: hand the request back to the loop task
        (it mutates the scheduler in ``_apply_pending``)."""
        self._requeue.append(req)
        self._wake.set()

    def _take_snapshot(self) -> None:
        self.last_snapshot = snapshot_mod.capture(self.engine)
        self._snap_pushed = {rid: st.n_pushed
                             for rid, st in self._streams.items()}
        self._steps_since_snap = 0

    def _recover_from_snapshot(self) -> None:
        """Roll the engine back to the last snapshot (in place: the
        captured decode graph reads the pool and keys it writes) and
        reconcile the live streams: tokens delivered since the snapshot
        will be emitted again identically, so each stream skips exactly
        that many; requests the snapshot never saw are resubmitted
        whole."""
        snap = self.last_snapshot
        snapshot_mod.restore(self.engine, snap)
        self.engine._stall_abort.clear()    # no stale abort latch
        tr = self.engine.tracer
        if tr is not None:
            # reconcile the rolled-back tracks before the replay: spans
            # opened since the snapshot no longer happened — unwind each
            # live track to its root, and open "queued" again for
            # requests the restore put back in the queues
            tr.instant("snapshot_restore",
                       recoveries=self.n_recoveries + 1)
            for req, _ in snap.requests:
                if not tr.open_spans(req.rid):
                    continue
                tr.unwind(req.rid, keep=1)
                if req.state in (RequestState.WAITING,
                                 RequestState.SWAPPED):
                    tr.begin("queued", cat="request", rid=req.rid)
        known = {r.rid for r, _ in snap.requests}
        for rid, stream in list(self._streams.items()):
            if rid in known:
                self._skip[rid] = \
                    stream.n_pushed - self._snap_pushed.get(rid, 0)
            else:
                # submitted after the snapshot: the restore dropped it
                # from the queues; enter it again whole and skip all the
                # stream already got
                self.engine.resubmit(stream.request)
                self._skip[rid] = stream.n_pushed
        self._c_recoveries.inc()
