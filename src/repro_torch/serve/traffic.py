"""Arrival-process generators and trace replay for the async serving stack
(the port's own copy of src/repro/serve/traffic.py, numpy only).

Three ways to produce a workload, all deterministic under a seed:

* :func:`poisson_times` — homogeneous Poisson process at ``rate``
  requests/s (exponential inter-arrival gaps).
* :func:`on_off_times` — bursty two-state (on/off) modulated Poisson:
  bursts of ``rate`` arrivals/s for ``on_s`` seconds separated by silent
  gaps of ``off_s`` seconds — the tail-latency stressor (a burst
  oversubscribes the slot pool; the idle gap lets it drain).
* :func:`load_trace` / :func:`save_trace` — replay a recorded JSONL trace
  (one ``{"t": ..., "prompt": [...], ...}`` object per line).

:func:`synthesize` assigns each arrival time a request drawn from a mix
of :class:`TrafficClass` profiles (prompt/generation length ranges, SLO
priority + TTFT deadline) — e.g. interactive-vs-batch — and
:func:`replay` submits a finished workload against an
:class:`~repro_torch.serve.frontend.AsyncServer`, sleeping to honor arrival
times (or compressed by ``speedup``) and collecting every stream.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.frontend import (AsyncServer, RejectedError,
                                       RequestStream)


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One request population in a traffic mix: prompt/output length
    ranges (inclusive low, exclusive high) plus the SLO class its
    requests carry."""
    name: str
    prompt_len: Tuple[int, int]
    max_new_tokens: Tuple[int, int]
    priority: int = 0
    deadline_s: Optional[float] = None
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of a workload: absolute arrival time (seconds from
    trace start) plus the request payload and SLO class."""
    t: float
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0
    deadline_s: Optional[float] = None
    cls: str = ""


# =============================================================================
# Arrival-time processes
# =============================================================================
def poisson_times(rate: float, n: int, seed: int = 0) -> List[float]:
    """``n`` arrival times of a homogeneous Poisson process at ``rate``
    requests/s (deterministic under ``seed``)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate, size=n)))

def on_off_times(rate: float, n: int, *, on_s: float, off_s: float,
                 seed: int = 0) -> List[float]:
    """``n`` arrival times of an on/off modulated Poisson process: the
    source emits at ``rate`` req/s while "on" for ``on_s`` seconds, then
    stays silent for ``off_s`` seconds, repeating.  Bursty traffic with
    this shape is what makes preempt-and-swap pay: a burst oversubscribes
    the pool and the off gap drains it."""
    if rate <= 0 or on_s <= 0 or off_s < 0:
        raise ValueError("rate/on_s must be > 0 and off_s >= 0")
    rng = np.random.default_rng(seed)
    times: List[float] = []
    period_start = 0.0
    t = 0.0
    while len(times) < n:
        t += float(rng.exponential(1.0 / rate))
        # lands past the current on-window: jump to the next burst
        while t > on_s:
            period_start += on_s + off_s
            t -= on_s
        times.append(period_start + t)
    return times


# =============================================================================
# Workload synthesis
# =============================================================================
def synthesize(times: Sequence[float], classes: Sequence[TrafficClass],
               vocab: int, seed: int = 0) -> List[Arrival]:
    """Assign each arrival time a request drawn from the ``classes`` mix
    (weighted choice; prompt tokens uniform over [1, vocab)).  The same
    (times, classes, vocab, seed) always yields the same workload."""
    if not classes:
        raise ValueError("need at least one TrafficClass")
    rng = np.random.default_rng(seed)
    w = np.asarray([c.weight for c in classes], np.float64)
    if (w <= 0).any():
        raise ValueError("class weights must be > 0")
    picks = rng.choice(len(classes), size=len(times), p=w / w.sum())
    out: List[Arrival] = []
    for t, k in zip(times, picks):
        c = classes[k]
        lp = int(rng.integers(c.prompt_len[0], c.prompt_len[1]))
        mnt = int(rng.integers(c.max_new_tokens[0], c.max_new_tokens[1]))
        prompt = rng.integers(1, vocab, size=lp).astype(np.int32)
        out.append(Arrival(t=float(t), prompt=prompt, max_new_tokens=mnt,
                           priority=c.priority, deadline_s=c.deadline_s,
                           cls=c.name))
    return out


# =============================================================================
# JSONL traces
# =============================================================================
def save_trace(path: str, arrivals: Sequence[Arrival]) -> None:
    """Write a workload as JSONL: one arrival object per line, sorted by
    time — a replayable, diffable artifact."""
    with open(path, "w") as f:
        for a in sorted(arrivals, key=lambda a: a.t):
            rec = {"t": a.t, "prompt": [int(x) for x in a.prompt],
                   "max_new_tokens": a.max_new_tokens,
                   "priority": a.priority}
            if a.deadline_s is not None:
                rec["deadline_s"] = a.deadline_s
            if a.cls:
                rec["cls"] = a.cls
            f.write(json.dumps(rec) + "\n")


def load_trace(path: str) -> List[Arrival]:
    """Load a JSONL trace written by :func:`save_trace` (or by hand:
    ``t``, ``prompt``, ``max_new_tokens`` required; ``priority``,
    ``deadline_s``, ``cls`` optional).

    Timestamps are *validated*, not repaired: a negative ``t`` or one
    earlier than the previous line raises ValueError naming the offending
    line — silently re-sorting a corrupt trace would hide exactly the
    kind of recording fault a replay is supposed to reproduce."""
    out: List[Arrival] = []
    prev_t, prev_ln = None, 0
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                a = Arrival(
                    t=float(rec["t"]),
                    prompt=np.asarray(rec["prompt"], np.int32),
                    max_new_tokens=int(rec["max_new_tokens"]),
                    priority=int(rec.get("priority", 0)),
                    deadline_s=rec.get("deadline_s"),
                    cls=rec.get("cls", ""))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}:{ln}: bad trace record: {e}") \
                    from None
            if not np.isfinite(a.t) or a.t < 0:
                raise ValueError(
                    f"{path}:{ln}: arrival time must be finite and >= 0, "
                    f"got {a.t}")
            if prev_t is not None and a.t < prev_t:
                raise ValueError(
                    f"{path}:{ln}: non-monotonic arrival time {a.t} "
                    f"(line {prev_ln} had {prev_t}); traces must be "
                    f"time-sorted")
            prev_t, prev_ln = a.t, ln
            out.append(a)
    return out


# =============================================================================
# Replay
# =============================================================================
async def replay(server: AsyncServer, arrivals: Sequence[Arrival], *,
                 speedup: float = 1.0
                 ) -> Tuple[Dict[int, RequestStream], List[Arrival]]:
    """Submit a workload against ``server``, honoring arrival times
    (divided by ``speedup``; ``float("inf")`` submits as fast as the
    loop allows), then drain every accepted stream to completion.

    Returns ``(streams by index into arrivals, rejected arrivals)`` —
    under ``admission="reject"`` the dropped requests are the baseline's
    cost; under ``"block"`` the rejected list is always empty.
    """
    if speedup <= 0:
        raise ValueError(f"speedup must be > 0, got {speedup}")
    arrivals = sorted(arrivals, key=lambda a: a.t)
    loop = asyncio.get_event_loop()
    start = loop.time()
    streams: Dict[int, RequestStream] = {}
    rejected: List[Arrival] = []
    consumers = []
    for i, a in enumerate(arrivals):
        due = a.t / speedup
        delay = start + due - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        try:
            stream = await server.submit(
                a.prompt, a.max_new_tokens, priority=a.priority,
                deadline_s=a.deadline_s)
        except RejectedError:
            rejected.append(a)
            continue
        streams[i] = stream
        consumers.append(asyncio.ensure_future(stream.tokens()))
    if consumers:
        # tolerate terminally failed streams (QuarantinedError /
        # RetriesExhausted under a fault plan): the failures stay
        # recorded on the engine's scheduler, the healthy streams drain
        await asyncio.gather(*consumers, return_exceptions=True)
    return streams, rejected
