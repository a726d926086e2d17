"""Per-request trace spans for the serving engine (``trace/v1``; mirrors
src/repro/obs/trace.py).

The engine records *spans* — begin/end pairs at host sync-point
granularity — on independent **tracks**: one track per request (keyed by
rid) plus one engine-level track (rid ``None``) for phase spans
(prefill batches, fused decode windows, swap traffic).  Because every
timestamp the tracer consumes is a ``time.perf_counter`` stamp the
engine *already takes* for its phase accounting, tracing adds zero
per-token host synchronization: a fused decode window contributes one
begin/end pair per live slot, all sharing the window's two existing
stamps.

Event model (``trace/v1`` JSONL):

* line 0 is a header: ``{"schema": "trace/v1", "meta": {...}}``;
* every other line is one event:
  ``{"seq", "ph", "name", "cat", "rid", "t_us"}`` plus optional
  ``"args"`` — ``ph`` is ``"B"`` (span begin), ``"E"`` (span end, name
  must match the innermost open ``B`` of the same track), or ``"I"``
  (instant).  ``seq`` increments by 1 from 0 in emission order, so a
  seeded run's event sequence is deterministic modulo the ``t_us``
  values; ``rid`` is ``null`` on the engine track.

Spans on one track are **strictly nested** — ``end`` closes the
innermost open span and raises on a name mismatch, which is how the
test suite catches lifecycle bugs (a span closed twice, or never).
``benchmarks/validate_trace.py`` re-derives the same nesting from the
JSONL alone with a per-track stack.

Chrome export (:func:`chrome_events` / :meth:`Tracer.write_chrome`)
maps tracks to Chrome ``trace_event`` threads (engine = tid 0, request
rid = tid rid+1) with ``B``/``E``/``i`` phases — load the file in
Perfetto / ``chrome://tracing`` to see queueing, prefill, decode
windows, preemptions, and retries per request on a common timeline.

``annotate=True`` additionally wraps engine-track spans in
``torch.profiler.record_function`` so ``torch.profiler`` traces line
up with engine spans (request tracks interleave and cannot nest
globally, so they are never annotated).
"""
from __future__ import annotations

import json
from time import perf_counter
from typing import Any, Dict, List, Optional, Sequence

TRACE_SCHEMA = "trace/v1"

EVENT_FIELDS = ("seq", "ph", "name", "cat", "rid", "t_us")


class _Span:
    __slots__ = ("name", "t_us", "annotation")

    def __init__(self, name: str, t_us: int, annotation=None):
        self.name = name
        self.t_us = t_us
        self.annotation = annotation


class Tracer:
    """Span recorder for one serving process.

    ``meta`` rides the JSONL header (seed, model, policy — anything the
    launcher wants alongside the events); ``annotate`` wraps
    engine-track spans in ``torch.profiler.record_function``.
    """

    def __init__(self, meta: Optional[Dict[str, Any]] = None,
                 annotate: bool = False):
        self.meta = dict(meta or {})
        self.annotate = bool(annotate)
        self.t0 = perf_counter()
        self.events: List[Dict[str, Any]] = []
        self._stacks: Dict[Optional[int], List[_Span]] = {}
        self._seq = 0

    # ------------------------------------------------------------- recording
    def _t_us(self, ts: Optional[float]) -> int:
        return int(round(((perf_counter() if ts is None else ts)
                          - self.t0) * 1e6))

    def _emit(self, ph: str, name: str, cat: str, rid: Optional[int],
              t_us: int, args: Optional[Dict[str, Any]]) -> None:
        ev: Dict[str, Any] = {"seq": self._seq, "ph": ph, "name": name,
                              "cat": cat, "rid": rid, "t_us": t_us}
        if args:
            ev["args"] = args
        self._seq += 1
        self.events.append(ev)

    def begin(self, name: str, cat: str = "engine",
              rid: Optional[int] = None, ts: Optional[float] = None,
              **args) -> None:
        """Open a span on ``rid``'s track (None = the engine track) at
        ``ts`` (a perf_counter stamp; defaults to now)."""
        t_us = self._t_us(ts)
        ann = None
        if self.annotate and rid is None:
            ann = _annotation(name)
        self._stacks.setdefault(rid, []).append(_Span(name, t_us, ann))
        self._emit("B", name, cat, rid, t_us, args or None)

    def end(self, name: str, cat: str = "engine",
            rid: Optional[int] = None, ts: Optional[float] = None,
            **args) -> None:
        """Close the innermost open span of ``rid``'s track; ``name``
        must match it (a mismatch is a lifecycle bug and raises)."""
        stack = self._stacks.get(rid)
        if not stack:
            raise ValueError(
                f"end({name!r}): no open span on track {rid}")
        top = stack.pop()
        if top.name != name:
            stack.append(top)
            raise ValueError(
                f"end({name!r}): innermost open span on track {rid} "
                f"is {top.name!r}")
        if top.annotation is not None:
            top.annotation.__exit__(None, None, None)
        self._emit("E", name, cat, rid, max(self._t_us(ts), top.t_us),
                   args or None)

    def span(self, name: str, cat: str = "engine",
             rid: Optional[int] = None, t0: Optional[float] = None,
             t1: Optional[float] = None, **args) -> None:
        """Record a complete span from two existing stamps (begin at
        ``t0``, end at ``t1``) — the zero-extra-sync path for fused
        decode windows and prefill batches."""
        self.begin(name, cat, rid, ts=t0, **args)
        self.end(name, cat, rid, ts=t1)

    def instant(self, name: str, cat: str = "engine",
                rid: Optional[int] = None, ts: Optional[float] = None,
                **args) -> None:
        self._emit("I", name, cat, rid, self._t_us(ts), args or None)

    # ------------------------------------------------------------- queries
    def open_spans(self, rid: Optional[int] = None) -> List[str]:
        """Names of the open spans on ``rid``'s track, outermost first."""
        return [s.name for s in self._stacks.get(rid, [])]

    def top(self, rid: Optional[int] = None) -> Optional[str]:
        stack = self._stacks.get(rid)
        return stack[-1].name if stack else None

    def open_tracks(self) -> List[Optional[int]]:
        """Track keys with at least one open span (None = engine)."""
        return [rid for rid, st in self._stacks.items() if st]

    # ------------------------------------------------------------- lifecycle
    def unwind(self, rid: Optional[int], ts: Optional[float] = None,
               keep: int = 0, **args) -> int:
        """End open spans on ``rid``'s track (innermost out) until at
        most ``keep`` remain; returns how many were closed.  Recovery
        paths (quarantine, snapshot restore) use this so a rolled-back
        request's track stays well-formed."""
        stack = self._stacks.get(rid, [])
        n = 0
        while len(stack) > keep:
            self.end(stack[-1].name, rid=rid, ts=ts, **args)
            n += 1
        return n

    def close_track(self, rid: Optional[int],
                    ts: Optional[float] = None, **args) -> None:
        """End every open span on ``rid``'s track (the outermost —
        normally the per-request root — gets ``args``, e.g. a terminal
        ``status``)."""
        stack = self._stacks.get(rid, [])
        while len(stack) > 1:
            self.end(stack[-1].name, rid=rid, ts=ts)
        if stack:
            self.end(stack[-1].name, rid=rid, ts=ts, **args)

    # ------------------------------------------------------------- export
    def header(self) -> Dict[str, Any]:
        return {"schema": TRACE_SCHEMA, "meta": self.meta}

    def write_jsonl(self, path) -> None:
        """``trace/v1`` JSONL: one header line, then one event per
        line in ``seq`` order."""
        with open(path, "w") as f:
            f.write(json.dumps(self.header(), sort_keys=True) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": chrome_events(self.events),
                       "displayTimeUnit": "ms",
                       "otherData": self.meta}, f)


def _annotation(name: str):
    """Enter a ``torch.profiler.record_function`` range named ``name``;
    ``Tracer.end`` exits it."""
    import torch
    ann = torch.profiler.record_function(name)
    ann.__enter__()
    return ann


def _tid(rid: Optional[int]) -> int:
    return 0 if rid is None else rid + 1


def chrome_events(events: Sequence[Dict[str, Any]]) -> List[Dict]:
    """Translate ``trace/v1`` events into Chrome ``trace_event`` dicts
    (Perfetto-loadable): tracks become threads of one process, B/E map
    verbatim, instants become thread-scoped ``i`` events."""
    out: List[Dict] = [{
        "ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
        "args": {"name": "engine"}}]
    named = {0}
    for ev in events:
        tid = _tid(ev["rid"])
        if tid not in named:
            named.add(tid)
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": f"request {ev['rid']}"}})
        ch = {"ph": ev["ph"] if ev["ph"] != "I" else "i",
              "pid": 1, "tid": tid, "ts": ev["t_us"],
              "name": ev["name"], "cat": ev["cat"]}
        if ch["ph"] == "i":
            ch["s"] = "t"
        if "args" in ev:
            ch["args"] = ev["args"]
        out.append(ch)
    return out


def validate_nesting(events: Sequence[Dict[str, Any]]
                     ) -> Dict[Optional[int], List[str]]:
    """Re-derive per-track span nesting with a stack (the same check
    ``benchmarks/validate_trace.py`` performs standalone): raises
    ValueError on an E without a matching innermost B, a non-monotone
    track clock, or a track left open; returns the per-track list of
    completed root-level span names."""
    stacks: Dict[Optional[int], List[Dict]] = {}
    roots: Dict[Optional[int], List[str]] = {}
    last_t: Dict[Optional[int], int] = {}
    for ev in events:
        rid = ev["rid"]
        if ev["t_us"] < last_t.get(rid, ev["t_us"]):
            raise ValueError(
                f"seq {ev['seq']}: track {rid} clock moved backwards")
        last_t[rid] = ev["t_us"]
        if ev["ph"] == "B":
            stacks.setdefault(rid, []).append(ev)
        elif ev["ph"] == "E":
            stack = stacks.get(rid)
            if not stack or stack[-1]["name"] != ev["name"]:
                raise ValueError(
                    f"seq {ev['seq']}: E {ev['name']!r} does not close "
                    f"the innermost B of track {rid} "
                    f"({stack[-1]['name'] if stack else 'empty'})")
            stack.pop()
            if not stack:
                roots.setdefault(rid, []).append(ev["name"])
    open_tracks = {rid: [e["name"] for e in st]
                   for rid, st in stacks.items() if st}
    if open_tracks:
        raise ValueError(f"tracks left open: {open_tracks}")
    return roots
