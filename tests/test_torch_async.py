"""The port's asyncio front end, traffic generators and latency plumbing
(mirrors tests/test_serve_async.py).

Routing requests through ``AsyncServer`` (pending queue, step loop,
per-request streams) changes *when* work is applied, never *what* is
computed: the streamed tokens equal those of driving the same
``ContinuousBatchingEngine`` synchronously, with the step on the loop or
in an executor thread.  The arrival generators, the trace format, the
nearest-rank percentile and the ``--arrival`` grammar are held against
the reference's own functions on the same inputs.  Every async test runs
under ``asyncio.wait_for`` so a deadlocked loop fails instead of hanging.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import parse_arrival
from repro_torch.models import Model, load_reduced
from repro_torch.obs.metrics import MetricsRegistry, percentile
from repro_torch.serve import (Arrival, AsyncServer,
                               ContinuousBatchingEngine, GenerationConfig,
                               QuarantinedError, RejectedError,
                               RetriesExhausted, TrafficClass,
                               latency_summary, load_trace, on_off_times,
                               poisson_times, replay, save_trace, synthesize)

torch.set_num_threads(1)

LENS = [4, 9, 14, 9, 4]
NEW = 6
PAGE = 8
TIMEOUT = 120.0


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=TIMEOUT))


@pytest.fixture(scope="module")
def setup():
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse("kv=int8@32:ocp"),
                       attn_impl="flash")
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in LENS]
    return cfg, model, params, prompts


def _engine(model, params, *, max_slots=2, prefix_cache=False, new=NEW,
            max_len=None, temperature=0.0):
    return ContinuousBatchingEngine(
        model, params, max_slots=max_slots, page_size=PAGE,
        max_len=max_len or (max(LENS) + new + 1), sync_every=4,
        gen=GenerationConfig(temperature=temperature),
        prefix_cache=prefix_cache)


# =============================================================================
# token identity: async front end == synchronous engine
# =============================================================================
@pytest.mark.parametrize("use_executor", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_async_streams_match_sync_engine(setup, use_executor, temperature):
    """The same prompts in the same order get the same rids and tokens
    whether submitted through AsyncServer or added directly, with the
    step on the loop or in an executor thread."""
    cfg, model, params, prompts = setup
    sync_eng = _engine(model, params, temperature=temperature)
    rids = [sync_eng.add_request(p, NEW) for p in prompts]
    want = sync_eng.run()

    async def go():
        eng = _engine(model, params, temperature=temperature)
        async with AsyncServer(eng, use_executor=use_executor) as srv:
            streams = [await srv.submit(p, NEW) for p in prompts]
            toks = [await s.tokens() for s in streams]
        assert srv.n_accepted == len(prompts) and srv.n_rejected == 0
        return [s.rid for s in streams], toks

    got_rids, got = _run(go())
    assert got_rids == rids
    for rid, toks in zip(rids, got):
        np.testing.assert_array_equal(toks, want[rid])


def test_async_iteration_streams_incrementally(setup):
    cfg, model, params, prompts = setup

    async def go():
        eng = _engine(model, params)
        async with AsyncServer(eng) as srv:
            stream = await srv.submit(prompts[0], NEW)
            seen = [tok async for tok in stream]
            rest = await stream.tokens()
        return seen, rest

    seen, rest = _run(go())
    assert len(seen) == NEW
    np.testing.assert_array_equal(np.asarray(seen, np.int32), rest)


def test_snapshot_every_keeps_streams(setup):
    """Snapshots taken by the step loop are host copies: the streams are
    those of a server without them."""
    cfg, model, params, prompts = setup

    async def go(every):
        eng = _engine(model, params)
        async with AsyncServer(eng, snapshot_every=every) as srv:
            streams = [await srv.submit(p, NEW) for p in prompts]
            toks = [(await s.tokens()).tolist() for s in streams]
        return srv, toks

    srv, with_snaps = _run(go(1))
    assert srv.last_snapshot is not None
    assert srv.last_snapshot.nbytes == srv.engine.kv_pool_nbytes
    assert _run(go(None))[1] == with_snaps


# =============================================================================
# admission control
# =============================================================================
def test_block_admission_bounds_backlog(setup):
    """admission='block': the backlog (pending + waiting) never exceeds
    max_queued while 8 submitters race a 1-slot engine."""
    cfg, model, params, prompts = setup
    peak = 0

    async def go():
        nonlocal peak
        eng = _engine(model, params, max_slots=1)
        async with AsyncServer(eng, max_queued=2) as srv:
            async def one(p):
                s = await srv.submit(p, NEW)
                return await s.tokens()

            tasks = [asyncio.ensure_future(one(prompts[i % len(prompts)]))
                     for i in range(8)]
            while not all(t.done() for t in tasks):
                peak = max(peak, srv._backlog())
                await asyncio.sleep(0)
            return await asyncio.gather(*tasks)

    outs = _run(go())
    assert len(outs) == 8 and all(len(o) == NEW for o in outs)
    assert peak <= 2


def test_reject_admission_raises_when_full(setup):
    """admission='reject': a request that cannot start at once (the one
    slot is busy) raises RejectedError instead of queueing."""
    cfg, model, params, prompts = setup

    async def go():
        eng = _engine(model, params, max_slots=1, new=16,
                      max_len=max(LENS) + 17)
        async with AsyncServer(eng, admission="reject") as srv:
            first = await srv.submit(prompts[0], 16)
            with pytest.raises(RejectedError):
                await srv.submit(prompts[1], 16)
            toks = await first.tokens()
        return srv.n_accepted, srv.n_rejected, toks

    acc, rej, toks = _run(go())
    assert (acc, rej) == (1, 1)
    assert len(toks) == 16


def test_server_validates_args_and_state(setup):
    cfg, model, params, prompts = setup
    eng = _engine(model, params)
    with pytest.raises(ValueError, match="admission"):
        AsyncServer(eng, admission="drop")
    with pytest.raises(ValueError, match="max_queued"):
        AsyncServer(eng, max_queued=0)
    with pytest.raises(ValueError, match="snapshot_every"):
        AsyncServer(eng, snapshot_every=0)
    with pytest.raises(ValueError, match="use_executor"):
        AsyncServer(eng, watchdog_s=5.0)
    assert AsyncServer(eng, use_executor=True, watchdog_s=5.0).watchdog_s \
        == 5.0

    async def go():
        with pytest.raises(RuntimeError, match="not running"):
            await AsyncServer(eng).submit(prompts[0], NEW)

    _run(go())


@pytest.mark.parametrize("retries", [0, 1])
def test_quarantine_retry_then_fail(setup, retries):
    """A request whose prompt holds a token with a NaN embedding row is
    quarantined at prefill; with a retry budget it re-enters the queue
    after its backoff (and is quarantined again), then its stream raises
    RetriesExhausted (QuarantinedError without a budget).  Its neighbour
    streams its tokens."""
    cfg, model, params, prompts = setup
    params = dict(params, embed=params["embed"].clone())
    params["embed"][7] = float("nan")
    healthy = prompts[1][prompts[1] != 7]
    poisoned = prompts[2].copy()
    poisoned[3] = 7
    want = _engine(model, params)
    rid = want.add_request(healthy, NEW)
    want = want.run()[rid]

    async def go():
        eng = _engine(model, params)
        async with AsyncServer(eng, retries=retries,
                               retry_backoff_s=0.001) as srv:
            good = await srv.submit(healthy, NEW)
            bad = await srv.submit(poisoned, NEW)
            err = RetriesExhausted if retries else QuarantinedError
            with pytest.raises(err, match="health guard"):
                await bad.tokens()
            return srv, eng, await good.tokens()

    srv, eng, got = _run(go())
    np.testing.assert_array_equal(got, want)
    assert (srv.n_retried, srv.n_failed) == (retries, 1)
    assert eng.n_quarantined == retries + 1
    assert [r.n_retries for r in eng.scheduler.failed] == [retries]


# =============================================================================
# latency stamps, percentile, metrics reset
# =============================================================================
def test_latency_stamps_recorded(setup):
    """Every finished request carries arrival / per-token / finish stamps:
    monotone, one per generated token, TTFT and ITL derivable; the window
    lengths go into the engine's histogram."""
    cfg, model, params, prompts = setup

    async def go():
        eng = _engine(model, params)
        async with AsyncServer(eng) as srv:
            streams = [await srv.submit(p, NEW, deadline_s=30.0)
                       for p in prompts]
            for s in streams:
                await s.tokens()
        return eng

    eng = _run(go())
    fin = eng.finished_in_window
    assert len(fin) == len(prompts)
    for r in fin:
        assert r.arrival_t <= r.t_admitted <= r.t_tokens[0]
        assert len(r.t_tokens) == len(r.out) == NEW
        assert all(b >= a for a, b in zip(r.t_tokens, r.t_tokens[1:]))
        assert r.t_finished >= r.t_tokens[-1]
        assert r.ttft_s >= 0 and len(r.itl_s) == NEW - 1
        assert r.deadline_met is True    # 30 s on a toy model
    summ = latency_summary(fin)
    assert summ["n_requests"] == len(prompts)
    for k in ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms"):
        assert summ[k] >= 0.0
    assert summ["slo_attainment"] == 1.0
    h = eng.metrics.histogram("engine.window_steps")
    assert h.count() == eng.n_syncs and sum(h.values()) == eng.n_steps
    assert eng.metrics.snapshot()["histograms"]["engine.window_steps"][
        "count"] == eng.n_syncs


def test_latency_summary_matches_reference():
    """The same stamped population summarizes as the reference's
    ``latency_summary`` does it (nearest rank, SLO attainment)."""
    from repro.serve import Request as JRequest
    from repro.serve.frontend import latency_summary as j_summary
    from repro_torch.serve import Request
    rng = np.random.default_rng(4)
    pop = []
    for rid in range(9):
        t0 = float(rng.uniform(0, 1))
        stamps = list(t0 + np.cumsum(rng.uniform(0, 0.2, size=4)))
        dl = None if rid % 3 == 0 else 0.1
        pop.append(dict(rid=rid, prompt=np.arange(3, dtype=np.int32),
                        max_new_tokens=4, deadline_s=dl, arrival_t=t0,
                        t_tokens=stamps, out=[1, 2, 3, 4]))
    mine = latency_summary([Request(**d) for d in pop])
    assert mine == j_summary([JRequest(**d) for d in pop])
    assert 0 < mine["slo_attainment"] < 1


def test_percentile_nearest_rank_matches_reference():
    from repro.obs.metrics import percentile as j_percentile
    s = [10.0, 20.0, 30.0, 40.0]
    assert [percentile(s, q) for q in (50, 75, 76, 100)] \
        == [20.0, 30.0, 40.0, 40.0]
    assert percentile([7.0], 99) == 7.0
    for bad in (([], 50), (s, 0), (s, 101)):
        with pytest.raises(ValueError):
            percentile(*bad)
    x = list(np.random.default_rng(1).normal(size=37))
    for q in (1, 33.3, 50, 90, 99, 100):
        assert percentile(x, q) == j_percentile(x, q)
    h = MetricsRegistry().histogram("h")
    for v in x:
        h.observe(v, role="k")
    assert h.percentile(99, role="k") == j_percentile(x, 99)


def test_reset_metrics_clears_latency_and_prefix_window(setup):
    """reset_metrics after a warm-up: finished_in_window, prefix counters,
    copy-on-write / preemption / swap accounting and phase times restart
    at zero, so a measurement window reports only its own requests."""
    cfg, model, params, prompts = setup
    eng = _engine(model, params, prefix_cache=True)
    for p in prompts[:3]:
        eng.add_request(p, NEW)
    eng.run()
    assert eng.finished_in_window and eng.prefix.lookups > 0
    eng.reset_metrics()
    assert eng.finished_in_window == []
    assert eng.prefix.lookups == 0 and eng.prefix.hits == 0
    assert eng.prefill_tokens_computed == 0 and eng.n_cow_forks == 0
    assert eng.n_preemptions == 0 and eng.n_restores == 0
    assert eng.swap_store.bytes_out == 0 and eng.swap_store.bytes_in == 0
    assert all(v == 0.0 for v in eng.phase.values())
    eng.add_request(prompts[3], NEW)
    eng.run()
    assert len(eng.finished_in_window) == 1
    assert latency_summary(eng.finished_in_window)["n_requests"] == 1.0


# =============================================================================
# traffic generators and traces: the reference's workloads, exactly
# =============================================================================
def test_arrival_processes_match_reference():
    from repro.serve import traffic as jt
    a = poisson_times(50.0, 64, seed=3)
    assert a == poisson_times(50.0, 64, seed=3) == \
        jt.poisson_times(50.0, 64, seed=3)
    assert a != poisson_times(50.0, 64, seed=4)
    assert all(t2 > t1 for t1, t2 in zip(a, a[1:]))
    on_s, off_s = 0.2, 1.0
    b = on_off_times(100.0, 50, on_s=on_s, off_s=off_s, seed=7)
    assert b == jt.on_off_times(100.0, 50, on_s=on_s, off_s=off_s, seed=7)
    assert all(t2 >= t1 for t1, t2 in zip(b, b[1:]))
    assert all((t % (on_s + off_s)) <= on_s + 1e-9 for t in b)
    with pytest.raises(ValueError):
        poisson_times(0.0, 4)
    with pytest.raises(ValueError):
        on_off_times(10.0, 4, on_s=0.0, off_s=1.0)


def test_synthesize_matches_reference_and_tags_classes():
    from repro.serve import traffic as jt
    spec = [("i", (4, 8), (2, 4), 0, 0.1, 2.0), ("b", (8, 16), (8, 12), 1,
                                                  None, 1.0)]
    classes = [TrafficClass(*c) for c in spec]
    times = poisson_times(20.0, 40, seed=1)
    a = synthesize(times, classes, vocab=128, seed=9)
    ref = jt.synthesize(times, [jt.TrafficClass(*c) for c in spec],
                        vocab=128, seed=9)
    assert len(a) == 40
    for x, y in zip(a, ref):
        assert (x.t, x.cls, x.max_new_tokens, x.priority, x.deadline_s) \
            == (y.t, y.cls, y.max_new_tokens, y.priority, y.deadline_s)
        np.testing.assert_array_equal(x.prompt, y.prompt)
    for x in a:
        c = classes[0] if x.cls == "i" else classes[1]
        assert c.prompt_len[0] <= len(x.prompt) < c.prompt_len[1]
        assert x.priority == c.priority and x.deadline_s == c.deadline_s
        assert x.prompt.min() >= 1
    assert {x.cls for x in a} == {"i", "b"}
    with pytest.raises(ValueError):
        synthesize(times, [], vocab=128)


def test_trace_round_trip_and_reference_reads_it(tmp_path):
    from repro.serve import traffic as jt
    classes = [TrafficClass("i", (4, 8), (2, 4), deadline_s=0.25),
               TrafficClass("b", (8, 16), (8, 12), priority=1)]
    arrivals = synthesize(poisson_times(20.0, 16, seed=2), classes,
                          vocab=64, seed=2)
    path = str(tmp_path / "trace.jsonl")
    save_trace(path, arrivals)
    for back in (load_trace(path), jt.load_trace(path)):
        assert len(back) == len(arrivals)
        for x, y in zip(sorted(arrivals, key=lambda a: a.t), back):
            assert (x.t, x.max_new_tokens, x.priority, x.deadline_s,
                    x.cls) == (y.t, y.max_new_tokens, y.priority,
                               y.deadline_s, y.cls)
            np.testing.assert_array_equal(x.prompt, y.prompt)
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"t": 0.0, "prompt": [1],
                               "max_new_tokens": 2}) + "\n{not json}\n")
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        load_trace(str(bad))
    back = tmp_path / "back.jsonl"
    back.write_text("".join(json.dumps({"t": t, "prompt": [1],
                                        "max_new_tokens": 2}) + "\n"
                            for t in (0.5, 0.2)))
    with pytest.raises(ValueError, match="non-monotonic"):
        load_trace(str(back))


def test_replay_serves_a_trace(setup):
    cfg, model, params, _ = setup
    classes = [TrafficClass("i", (4, 10), (2, 5), deadline_s=10.0)]
    arrivals = synthesize(poisson_times(50.0, 6, seed=5), classes,
                          vocab=cfg.vocab, seed=5)

    async def go():
        eng = _engine(model, params, new=8, max_len=24)
        async with AsyncServer(eng) as srv:
            with pytest.raises(ValueError, match="speedup"):
                await replay(srv, [Arrival(t=0.0, prompt=np.ones(
                    4, np.int32), max_new_tokens=2)], speedup=0.0)
            return await replay(srv, arrivals, speedup=float("inf"))

    streams, rejected = _run(go())
    assert rejected == [] and len(streams) == len(arrivals)
    for i, a in enumerate(sorted(arrivals, key=lambda a: a.t)):
        assert len(streams[i]._out) == a.max_new_tokens


# =============================================================================
# the launcher: --arrival grammar and the async path
# =============================================================================
def test_parse_arrival_grammar_matches_reference():
    from repro.launch.serve import parse_arrival as j_parse
    for spec in ("batch", "poisson:12.5", "onoff:60:0.15:2.0",
                 "trace:/data/a:b.jsonl"):
        assert parse_arrival(spec) == j_parse(spec)
    assert parse_arrival("onoff:60:0.15:2.0") == ("onoff",
                                                  (60.0, 0.15, 2.0))
    for bad in ("poisson", "poisson:x", "onoff:60", "burst:1", "trace"):
        with pytest.raises(ValueError, match="bad --arrival"):
            parse_arrival(bad)


def test_launcher_async_probe(capsys):
    """The async CLI path on the reduced model: two classes under on/off
    arrivals, preempt-and-swap on; prints the latency and swap lines."""
    serve_main(["--arch", "chatglm3_6b", "--reduced", "--device", "cpu",
                "--paged", "--preempt", "--arrival", "onoff:60:0.15:2.0",
                "--slo", "0.35", "--requests", "8", "--new-tokens", "6",
                "--quant", "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"])
    out = capsys.readouterr().out
    assert "8 served / 0 rejected of 8 arrivals" in out
    for line in ("TTFT p50", "SLO attainment", "swap ", "preempt-and-swap:"):
        assert line in out
    with pytest.raises(SystemExit):
        serve_main(["--arch", "chatglm3_6b", "--reduced", "--device", "cpu",
                    "--slo", "0.3"])
