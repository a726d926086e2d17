"""Engine snapshot / restore in the port: a token-identical rewind of a live
engine (mirrors tests/test_serve_snapshot.py).

``serve.snapshot.capture`` freezes a running engine — page pool (host
copy), block tables and free list, scheduler queues and per-request
state, swap store, prefix trie, slot mirrors, sampling keys and counters
— and ``restore`` rewinds the same engine to that instant.  Finishing a
workload after a restore gives the tokens of an uninterrupted run,
however far the engine had run past the snapshot: greedy and at
temperature 0.8, with the prefix trie warm and with a request swapped
out.  Restore writes into the tensors the engine (and its captured decode
step) already holds; it never rebinds them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.serve import (ContinuousBatchingEngine, GenerationConfig,
                               capture, restore)

torch.set_num_threads(1)

MIXED = "kv_key=int8@32:paper,kv_value=e4m3@32:paper"
PAGE = 8
NEW = 10


@pytest.fixture(scope="module")
def mixed():
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(MIXED),
                       attn_impl="flash")
    model = Model(cfg, device="cpu")
    return cfg, model, model.init(seed=0)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
            for n in (7, 12, 9)]


def _engine(model, params, temperature=0.0, **kw):
    kw.setdefault("max_slots", 4)
    return ContinuousBatchingEngine(
        model, params, page_size=PAGE, max_len=40, sync_every=4,
        gen=GenerationConfig(temperature=temperature), **kw)


def _clean(mixed, temperature=0.0):
    cfg, model, params = mixed
    eng = _engine(model, params, temperature)
    rids = [eng.add_request(p, NEW) for p in _prompts(cfg)]
    return rids, eng.run()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("steps_past", [0, 2])
def test_restore_mid_stream_token_identical(mixed, steps_past, temperature):
    cfg, model, params = mixed
    rids, want = _clean(mixed, temperature)
    eng = _engine(model, params, temperature)
    pool, keys = eng.pool, eng.window.keys
    ptrs = {k: v.data_ptr() for k, v in pool.items()}
    for p in _prompts(cfg):
        eng.add_request(p, NEW)
    eng.step()                            # requests are mid-generation
    snap = capture(eng)
    assert snap.nbytes == eng.kv_pool_nbytes
    for _ in range(steps_past):           # advance past the snapshot...
        eng.step()
    restore(eng, snap)                    # ...and rewind
    # the pool and keys the captured step reads were written, not rebound
    assert eng.pool is pool and eng.window.keys is keys
    assert {k: v.data_ptr() for k, v in eng.pool.items()} == ptrs
    assert eng._bt_version == -1
    out = eng.run()
    assert set(out) == set(rids)
    for r in rids:
        np.testing.assert_array_equal(out[r], want[r])


def test_restore_after_completion_replays_identically(mixed):
    """A finished engine rewinds too: the finished list is cut back to the
    snapshot's, and the replay finishes every request with the same
    tokens; counters and the block manager rewind with it."""
    cfg, model, params = mixed
    rids, want = _clean(mixed)
    eng = _engine(model, params)
    for p in _prompts(cfg):
        eng.add_request(p, NEW)
    eng.step()
    snap = capture(eng)
    steps, version = eng.n_steps, eng.blocks.version
    first = eng.run()
    assert eng.n_steps > steps
    restore(eng, snap)
    assert not eng.scheduler.finished
    assert eng.n_steps == steps and eng.blocks.version > version
    again = eng.run()
    for r in rids:
        np.testing.assert_array_equal(first[r], want[r])
        np.testing.assert_array_equal(again[r], want[r])


def test_snapshot_is_an_isolated_host_copy(mixed):
    """Stepping the engine after capture leaves the snapshot as it was:
    per-request state, slot mirrors and the pool copy stay frozen."""
    cfg, model, params = mixed
    eng = _engine(model, params)
    rids = [eng.add_request(p, NEW) for p in _prompts(cfg)]
    eng.step()
    snap = capture(eng)
    out_lens = {r.rid: len(r.out) for r in eng.scheduler.running.values()}
    lengths = snap.engine["lengths"].copy()
    pool = {k: v.clone() for k, v in snap.pool.items()}
    eng.step()                            # the engine advances...
    for req, fields in snap.requests:     # ...the snapshot does not
        assert len(fields["out"]) == out_lens[req.rid]
        assert len(req.out) > len(fields["out"])
    np.testing.assert_array_equal(snap.engine["lengths"], lengths)
    for k, v in snap.pool.items():
        assert v.device.type == "cpu" and torch.equal(v, pool[k])
        assert not torch.equal(v, eng.pool[k])
    restore(eng, snap)
    assert set(eng.run()) == set(rids)


def test_restore_with_prefix_cache_keeps_trie_serving(mixed):
    """Capture with a warm trie; after restore the trie still matches (its
    pins ride the restored block manager: no double pinning)."""
    cfg, model, params = mixed
    rng = np.random.default_rng(11)
    warm = rng.integers(1, cfg.vocab, size=PAGE).astype(np.int32)
    eng = _engine(model, params, prefix_cache=True)
    eng.add_request(warm, 1)
    eng.run()
    hits0, pins = eng.prefix.hits, eng.blocks._pins.copy()
    snap = capture(eng)
    tail = rng.integers(1, cfg.vocab, size=5).astype(np.int32)
    eng.add_request(np.concatenate([warm, tail]), 3)
    want = eng.run()
    assert eng.prefix.hits == hits0 + 1
    restore(eng, snap)
    assert eng.prefix.hits == hits0
    np.testing.assert_array_equal(eng.blocks._pins, pins)
    rid2 = eng.add_request(np.concatenate([warm, tail]), 3)
    assert rid2 not in want               # rids never roll back
    out = eng.run()
    assert eng.prefix.hits == hits0 + 1
    np.testing.assert_array_equal(out[rid2], want[min(want)])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_restore_preserves_swapped_out_requests(mixed, temperature):
    """A request in the host swap store at capture time restores after the
    rewind (the store's entries are part of the snapshot)."""
    cfg, model, params = mixed
    eng = _engine(model, params, temperature, max_slots=2, preempt=True)
    rng = np.random.default_rng(3)
    victim = eng.add_request(
        rng.integers(1, cfg.vocab, size=9).astype(np.int32), 12,
        priority=5)
    eng.step()
    for _ in range(2):
        eng.add_request(rng.integers(1, cfg.vocab, size=17)
                        .astype(np.int32), 6, priority=0)
    for _ in range(20):
        if victim in eng.swap_store:
            break
        eng.step()
    assert victim in eng.swap_store       # preempted and resident
    snap = capture(eng)
    # run() reports only requests finishing during the call: compare on
    # want's keys, among which the victim is (it still owes tokens)
    want = eng.run()
    assert victim in want
    restore(eng, snap)
    assert victim in eng.swap_store       # the entry survived the rewind
    out = eng.run()
    assert set(out) == set(want)
    for r in want:
        np.testing.assert_array_equal(out[r], want[r])
    assert eng.n_restores == eng.n_preemptions >= 1


def test_restore_drops_later_arrivals_and_resubmit_reenters(mixed):
    """A request submitted after the snapshot is not in the restored
    queues; ``resubmit`` re-enters it under its rid, and it gets the
    tokens it got before the rewind."""
    cfg, model, params = mixed
    eng = _engine(model, params)
    first = [eng.add_request(p, NEW) for p in _prompts(cfg)[:2]]
    eng.step()
    snap = capture(eng)
    late = eng.add_request(_prompts(cfg)[2], NEW)
    req = next(r for r in eng.scheduler.waiting if r.rid == late)
    want = eng.run()
    restore(eng, snap)
    assert late not in {r.rid for r in eng.scheduler.waiting}
    assert req.out                        # its stale tokens, until...
    eng.resubmit(req)                     # ...it re-enters, reset
    assert req.out == [] and req in eng.scheduler.waiting
    out = eng.run()
    assert set(out) == set(first) | {late}
    for r in out:
        np.testing.assert_array_equal(out[r], want[r])
