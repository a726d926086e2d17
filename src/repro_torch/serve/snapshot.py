"""Engine snapshot / restore: a token-identical serving checkpoint
(mirrors src/repro/serve/snapshot.py).

``capture(engine)`` copies everything the continuous-batching engine
needs to reproduce its stream bit for bit from this boundary on:

* the paged KV pool (MX codes still packed), copied to host memory;
* the :class:`~repro_torch.serve.paging.BlockManager`: block tables, free
  list, per-slot ownership and shared flags, refcounts, pins, version;
* the scheduler: waiting / running membership, free slots, and the
  mutable state (tokens, budgets, stamps, preemption and retry counts)
  of every request the engine tracks;
* the host swap store's entries and traffic counters;
* the prefix trie (node keys, canonical pages, LRU clocks); its pins are
  not taken again on restore, they ride the block manager's arrays;
* the engine's slot mirrors (current token, lengths, budgets), the
  per-slot sampling keys and the serving counters.

``restore(engine, snap)`` writes that state back **into the same live
objects**.  Request objects are mutated in place, so front-end streams
holding them keep working.  The pool and the keys are copied into the
tensors the engine already holds (``copy_``): the captured decode graph
reads those very tensors, so rebinding them would leave it serving stale
pages.  ``blocks.version`` is bumped and the engine's table version
reset, so the block table is uploaded again before the next window.
Two counters do not roll back: ``engine._next_rid`` and
``scheduler._seq`` keep the larger of their current and saved values,
so requests submitted after the snapshot can be resubmitted without rid
collisions; requests the snapshot never saw drop out of the queues (the
front end re-enters them through ``engine.resubmit``).  The port keys
each request's sampling stream by (engine seed, rid) with no engine-wide
key, so there is none to save.

The snapshot is an in-memory object (host tensors + plain Python), sized
by the page pool; not an on-disk format.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serve.swap import Pages, sync, to_host


def _dump_trie(node) -> Dict[str, Any]:
    return {"key": node.key, "page": node.page, "last_use": node.last_use,
            "children": [_dump_trie(c) for c in node.children.values()]}


def _load_trie(parent, dump: Dict[str, Any], node_cls) -> int:
    """Rebuild ``dump``'s children under ``parent``; returns the nodes
    made.  Pages are not pinned here: the restored block manager's pin
    array already carries the trie's pins."""
    n = 0
    for cd in dump["children"]:
        child = node_cls(tuple(cd["key"]), cd["page"], parent)
        child.last_use = cd["last_use"]
        parent.children[child.key] = child
        n += 1 + _load_trie(child, cd, node_cls)
    return n


_REQ_FIELDS = ("state", "slot", "matched_tokens", "cow_pending", "seq",
               "swap_pages", "n_preemptions", "error", "n_retries",
               "arrival_t", "t_admitted", "t_finished",
               "priority", "deadline_s", "max_new_tokens")

_COUNTERS = ("n_steps", "n_syncs", "n_generated", "n_prefill_batches",
             "n_hit_batches", "prefill_tokens_computed", "n_cow_forks",
             "peak_mapped_pages", "peak_shared_pages", "n_preemptions",
             "n_restores", "n_quarantined")


@dataclasses.dataclass
class EngineSnapshot:
    """One ``capture()`` result: live request references (restore mutates
    them in place) and host copies of everything else; ``nbytes`` is the
    pool payload's size."""
    pool: Pages
    blocks: Dict[str, Any]
    sched: Dict[str, Any]
    requests: List[Tuple[Any, Dict[str, Any]]]   # (request, saved fields)
    swap: Dict[str, Any]
    prefix: Optional[Dict[str, Any]]
    engine: Dict[str, Any]
    nbytes: int


def _tracked_requests(engine) -> List[Any]:
    s = engine.scheduler
    seen, out = set(), []
    for r in (list(s.waiting) + list(s.running.values()) + list(s.finished)
              + list(s.failed)):
        if id(r) not in seen:
            seen.add(id(r))
            out.append(r)
    return out


def capture(engine) -> EngineSnapshot:
    """Checkpoint ``engine`` (a ContinuousBatchingEngine) to host memory:
    the pool and the sampling keys in one batch of copies and one
    synchronize."""
    blocks = engine.blocks
    s = engine.scheduler
    pool = {name: to_host(leaf) for name, leaf in engine.pool.items()}
    keys = to_host(engine.window.keys)
    sync(engine.device)
    requests = []
    for r in _tracked_requests(engine):
        fields = {k: getattr(r, k) for k in _REQ_FIELDS}
        fields["out"] = list(r.out)
        fields["t_tokens"] = list(r.t_tokens)
        requests.append((r, fields))
    store = engine.swap_store
    px = engine.prefix
    return EngineSnapshot(
        pool=pool,
        blocks={"version": blocks.version, "free": list(blocks._free),
                "tables": blocks.tables.copy(),
                "owned": [list(o) for o in blocks._owned],
                "shared": [list(sh) for sh in blocks._shared],
                "table_refs": blocks._table_refs.copy(),
                "pins": blocks._pins.copy()},
        sched={"waiting": list(s.waiting), "running": dict(s.running),
               "n_finished": len(s.finished), "n_failed": len(s.failed),
               "free_slots": list(s._free_slots), "seq": s._seq,
               "n_preemptions": s.n_preemptions,
               "n_restores": s.n_restores},
        requests=requests,
        swap={"entries": dict(store._entries),
              "bytes_out": store.bytes_out, "bytes_in": store.bytes_in,
              "peak_resident_bytes": store.peak_resident_bytes},
        prefix=None if px is None else {
            "trie": _dump_trie(px._root), "n_nodes": px._n_nodes,
            "tick": px._tick, "lookups": px.lookups, "hits": px.hits,
            "tokens_matched": px.tokens_matched},
        engine={"cur_tok": engine._cur_tok.copy(),
                "lengths": engine._lengths.copy(),
                "remaining": engine._remaining.copy(),
                "slot_keys": keys, "next_rid": engine._next_rid,
                "counters": {k: getattr(engine, k) for k in _COUNTERS},
                "metrics_start": engine._metrics_start,
                "phase": dict(engine.phase)},
        nbytes=sum(t.numel() * t.element_size() for t in pool.values()))


def restore(engine, snap: EngineSnapshot) -> None:
    """Write ``snap`` back into ``engine``'s live objects, the pool and
    the sampling keys into the tensors its captured graph reads."""
    blocks = engine.blocks
    s = engine.scheduler
    for r, fields in snap.requests:
        for k in _REQ_FIELDS:
            setattr(r, k, fields[k])
        r.out = list(fields["out"])
        r.t_tokens = list(fields["t_tokens"])
    b = snap.blocks
    blocks._free = list(b["free"])
    blocks.tables[...] = b["tables"]
    blocks._owned = [list(o) for o in b["owned"]]
    blocks._shared = [list(sh) for sh in b["shared"]]
    blocks._table_refs[...] = b["table_refs"]
    blocks._pins[...] = b["pins"]
    # bump (never rewind) the version: the engine uploads its block table
    # again before the next window
    blocks.version = max(blocks.version, b["version"]) + 1
    s.waiting = list(snap.sched["waiting"])
    s.running = dict(snap.sched["running"])
    del s.finished[snap.sched["n_finished"]:]
    del s.failed[snap.sched["n_failed"]:]
    s._free_slots = list(snap.sched["free_slots"])
    s._seq = max(s._seq, snap.sched["seq"])
    s.n_preemptions = snap.sched["n_preemptions"]
    s.n_restores = snap.sched["n_restores"]
    store = engine.swap_store
    store._entries = dict(snap.swap["entries"])
    store.bytes_out = snap.swap["bytes_out"]
    store.bytes_in = snap.swap["bytes_in"]
    store.peak_resident_bytes = snap.swap["peak_resident_bytes"]
    px = engine.prefix
    if px is not None and snap.prefix is not None:
        node_cls = type(px._root)
        px._root = node_cls((), -1, None)
        px._n_nodes = _load_trie(px._root, snap.prefix["trie"], node_cls)
        assert px._n_nodes == snap.prefix["n_nodes"], \
            "trie dump/rebuild node count mismatch"
        px._tick = snap.prefix["tick"]
        px.lookups = snap.prefix["lookups"]
        px.hits = snap.prefix["hits"]
        px.tokens_matched = snap.prefix["tokens_matched"]
    e = snap.engine
    engine._cur_tok[...] = e["cur_tok"]
    engine._lengths[...] = e["lengths"]
    engine._remaining[...] = e["remaining"]
    engine._next_rid = max(engine._next_rid, e["next_rid"])
    for k, v in e["counters"].items():
        setattr(engine, k, v)
    engine._metrics_start = e["metrics_start"]
    engine.phase = e["phase"]
    for name, leaf in engine.pool.items():
        leaf.copy_(snap.pool[name], non_blocking=True)
    engine.window.keys.copy_(e["slot_keys"], non_blocking=True)
    sync(engine.device)
    engine._bt_version = -1         # upload the block table again
    engine.quarantined_in_step = []
