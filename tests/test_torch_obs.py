"""The port's observability layer: trace spans, registry merge, and the
engine's event stream against the JAX engine's (mirrors the tracer and
merge cases of tests/test_obs.py).

* **Tracer and registry units** (no engine): span lifecycle, clamped end
  times, unwind / close_track, the event schema, JSONL and Chrome export,
  ``validate_nesting``; ``merge`` on counters, gauges, histograms and
  registries.
* **Event stream = the reference's**: a seeded workload that preempts
  (a low-priority request swapped out by two urgent ones over two slots)
  and quarantines (a ``prefill_nan`` fault) runs on the port and on the
  JAX engine with a tracer each; the two event streams are equal in
  every field but ``t_us`` (same ``seq``, ``ph``, ``name``, ``cat``,
  ``rid`` and ``args``), and ``benchmarks/validate_trace.py``, run as it
  stands, accepts the port's JSONL.
* **Lifecycle under faults and retries** through ``AsyncServer``: every
  track nests and closes once, with the right terminal status; the
  engine's counters equal its registry snapshot, and ``obs_interval``
  publishes the ``mx.*`` gauges per KV role.
"""
import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             Tracer, chrome_events, validate_nesting)
from repro_torch.obs.trace import EVENT_FIELDS, TRACE_SCHEMA
from repro_torch.serve import (AsyncServer, ContinuousBatchingEngine,
                               FaultPlan, RetriesExhausted)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POLICY = "kv=int8@32:ocp"
PAGE = 8
NEW = 6
TIMEOUT = 120.0


# =============================================================================
# registry merge
# =============================================================================
def test_counter_merge_adds():
    a, b = Counter("c"), Counter("c")
    a.inc(1, k="x")
    b.inc(2, k="x")
    b.inc(5, k="y")
    a.merge(b)
    assert a.value(k="x") == 3 and a.value(k="y") == 5


def test_gauge_and_histogram_merge():
    g, h = Gauge("g"), Gauge("g")
    g.set(1, role="a")
    g.set(4, role="b")
    h.set(7, role="b")
    g.merge(h)
    assert g.value(role="a") == 1 and g.value(role="b") == 7
    x, y = Histogram("h"), Histogram("h")
    x.observe(1.0)
    y.observe(3.0)
    y.observe(2.0, op="z")
    x.merge(y)
    assert x.values() == [1.0, 3.0] and x.values(op="z") == [2.0]


def test_registry_merge_and_snapshot_shape():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("c").inc(1)
    b.counter("c").inc(2)
    b.gauge("g").set(9)
    b.histogram("h").observe(4.0)
    a.merge(b)
    snap = a.snapshot()
    assert set(snap) == {"counters", "gauges", "histograms"}
    assert snap["counters"]["c"] == 3
    assert snap["gauges"]["g"] == 9
    assert snap["histograms"]["h"]["count"] == 1
    json.dumps(snap)
    c = MetricsRegistry()
    c.gauge("c")
    with pytest.raises(TypeError):           # a kind conflict is refused
        c.merge(b)


# =============================================================================
# Tracer: span lifecycle, export, nesting validation
# =============================================================================
def test_tracer_span_lifecycle_and_mismatch():
    tr = Tracer()
    tr.begin("request", cat="request", rid=0)
    tr.begin("queued", cat="request", rid=0)
    assert tr.open_spans(0) == ["request", "queued"]
    assert tr.top(0) == "queued"
    with pytest.raises(ValueError, match="innermost open span"):
        tr.end("request", rid=0)
    assert tr.open_spans(0) == ["request", "queued"]
    tr.end("queued", rid=0)
    tr.end("request", rid=0)
    with pytest.raises(ValueError, match="no open span"):
        tr.end("request", rid=0)
    assert tr.open_tracks() == []
    assert validate_nesting(tr.events) == {0: ["request"]}


def test_tracer_end_clamps_to_begin_time():
    tr = Tracer()
    t = tr.t0 + 1.0
    tr.begin("s", ts=t)
    tr.end("s", ts=t - 0.5)
    b, e = tr.events
    assert e["t_us"] == b["t_us"] == 1_000_000
    validate_nesting(tr.events)


def test_tracer_unwind_and_close_track():
    tr = Tracer()
    tr.begin("request", rid=3)
    tr.begin("queued", rid=3)
    tr.begin("inner", rid=3)
    assert tr.unwind(3, keep=1) == 2
    assert tr.open_spans(3) == ["request"]
    tr.close_track(3, status="failed")
    assert tr.open_tracks() == []
    last = tr.events[-1]
    assert last["ph"] == "E" and last["name"] == "request"
    assert last["args"] == {"status": "failed"}
    validate_nesting(tr.events)


def test_tracer_event_schema_and_determinism():
    def record(tr):
        tr.begin("a", ts=tr.t0)
        tr.instant("mark", ts=tr.t0, k=1)
        tr.end("a", ts=tr.t0)
        return tr

    tr = record(Tracer(meta={"seed": 7}))
    assert tr.header() == {"schema": TRACE_SCHEMA, "meta": {"seed": 7}}
    for i, ev in enumerate(tr.events):
        assert ev["seq"] == i
        assert set(ev) - {"args"} == set(EVENT_FIELDS)
    assert record(Tracer(meta={"seed": 7})).events == tr.events


def test_tracer_annotate_wraps_engine_spans_for_the_profiler():
    """``annotate=True`` opens a ``torch.profiler.record_function`` range
    per engine-track span (request tracks are never annotated)."""
    tr = Tracer(annotate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.begin("decode_window")
        tr.begin("request", rid=1)
        torch.ones(4).sum()
        tr.end("request", rid=1)
        tr.end("decode_window")
    names = {e.name for e in prof.events()}
    assert "decode_window" in names and "request" not in names
    validate_nesting(tr.events)


def test_tracer_write_jsonl_and_chrome(tmp_path):
    tr = Tracer(meta={"arch": "t"})
    tr.span("decode_window", t0=tr.t0, t1=tr.t0, steps=4)
    tr.begin("request", cat="request", rid=2, ts=tr.t0)
    tr.instant("admitted", cat="request", rid=2, ts=tr.t0)
    tr.end("request", rid=2, ts=tr.t0)
    p = tmp_path / "t.jsonl"
    tr.write_jsonl(p)
    lines = [json.loads(x) for x in p.read_text().splitlines()]
    assert lines[0] == {"schema": "trace/v1", "meta": {"arch": "t"}}
    assert lines[1:] == tr.events
    evs = chrome_events(tr.events)
    assert {m["tid"]: m["args"]["name"] for m in evs if m["ph"] == "M"} \
        == {0: "engine", 3: "request 2"}
    inst = [e for e in evs if e["ph"] == "i"]
    assert inst[0]["s"] == "t" and inst[0]["tid"] == 3
    tr.write_chrome(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"] \
        == evs


def test_validate_nesting_rejects_malformed_streams():
    def ev(seq, ph, name, rid, t):
        return {"seq": seq, "ph": ph, "name": name, "cat": "x",
                "rid": rid, "t_us": t}
    with pytest.raises(ValueError, match="does not close"):
        validate_nesting([ev(0, "B", "a", 0, 0), ev(1, "E", "b", 0, 1)])
    with pytest.raises(ValueError, match="clock moved backwards"):
        validate_nesting([ev(0, "I", "a", 0, 5), ev(1, "I", "b", 0, 1)])
    with pytest.raises(ValueError, match="tracks left open"):
        validate_nesting([ev(0, "B", "a", 0, 0)])
    assert validate_nesting([
        ev(0, "B", "a", 0, 0), ev(1, "B", "b", 1, 0),
        ev(2, "E", "a", 0, 2), ev(3, "E", "b", 1, 3)]) \
        == {0: ["a"], 1: ["b"]}


# =============================================================================
# The engine's event stream = the JAX engine's
# =============================================================================
@pytest.fixture(scope="module")
def models():
    import jax
    from repro.models import Model as JModel
    from repro.models import load_reduced as j_load_reduced
    from repro.models.config import QuantPolicy as JPolicy
    from repro_torch.models.params import from_numpy
    from torch_parity import params_to_numpy
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(POLICY))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(POLICY))
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, from_numpy(params_to_numpy(jp), tcfg, "cpu")


def _script(eng, vocab):
    """A low-priority request mid-generation, then three urgent ones over
    two slots: the first is swapped out and restored; the plan poisons
    rid 2's prefill, so it is quarantined."""
    rng = np.random.default_rng(3)
    eng.add_request(rng.integers(1, vocab, size=9).astype(np.int32), 12,
                    priority=5)
    eng.step()
    for n in (17, 11, 14):
        eng.add_request(rng.integers(1, vocab, size=n).astype(np.int32), 6,
                        priority=0)
    out = {r: v.tolist() for r, v in eng.run().items()}
    eng.finalize_trace()
    return out


def _strip(events):
    return [{k: v for k, v in ev.items() if k != "t_us"} for ev in events]


def test_event_stream_matches_jax_engine(models, tmp_path):
    from repro.obs import Tracer as JTracer
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve import FaultPlan as JPlan
    from repro.serve import GenerationConfig as JGen
    jm, jp, tm, tp = models
    kw = dict(max_slots=2, page_size=PAGE, max_len=40, sync_every=4,
              preempt=True)
    text = "prefill_nan:rid=2"
    jtr = JTracer()
    jeng = JEngine(jm, jp, gen=JGen(max_new_tokens=12), tracer=jtr,
                   faults=JPlan.parse(text, seed=1), **kw)
    want = _script(jeng, tm.cfg.vocab)
    tr = Tracer(meta={"policy": POLICY})
    eng = ContinuousBatchingEngine(tm, tp, tracer=tr,
                                   faults=FaultPlan.parse(text, seed=1),
                                   **kw)
    got = _script(eng, tm.cfg.vocab)
    assert got == want
    assert eng.n_preemptions >= 1 and eng.n_quarantined == 1
    assert _strip(tr.events) == _strip(jtr.events)
    roots = validate_nesting(tr.events)
    for rid in range(4):
        assert roots[rid] == ["request"], rid
    names = {(e["rid"], e["name"], e["ph"]) for e in tr.events}
    for want_ev in ((0, "preempt", "I"), (0, "restore", "B"),
                    (2, "quarantine", "I"), (None, "swap_out", "B"),
                    (None, "swap_restore", "B"),
                    (None, "prefill_batch", "B"),
                    (None, "decode_window", "B")):
        assert want_ev in names, want_ev
    path = tmp_path / "trace.jsonl"
    tr.write_jsonl(path)
    res = subprocess.run([sys.executable,
                          str(ROOT / "benchmarks" / "validate_trace.py"),
                          str(path)], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "valid trace/v1" in res.stdout


# =============================================================================
# Lifecycle under faults and retries; counters == registry; mx gauges
# =============================================================================
def _prompts(vocab, lens=(7, 12, 9), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _engine(models, **kw):
    _, _, tm, tp = models
    kw.setdefault("max_slots", 4)
    return ContinuousBatchingEngine(tm, tp, page_size=PAGE, max_len=40,
                                    sync_every=4, **kw)


def test_trace_lifecycle_under_faults_and_retry(models):
    """One request quarantined once and retried to success, one poisoned
    on every attempt until RetriesExhausted: every track stays
    well-formed and finishes with exactly one root ``request`` span
    carrying the right terminal status."""
    plan = FaultPlan.parse("prefill_nan:rid=1,prefill_nan:rid=2:always",
                           seed=3)
    tracer = Tracer(meta={"plan": str(plan.faults)})
    eng = _engine(models, faults=plan, tracer=tracer,
                  metrics=MetricsRegistry())
    prompts = _prompts(models[2].cfg.vocab)

    async def go():
        async with AsyncServer(eng, retries=1,
                               retry_backoff_s=0.01) as srv:
            streams = [await srv.submit(p, NEW) for p in prompts]
            res = await asyncio.gather(
                *(s.tokens() for s in streams), return_exceptions=True)
            return srv, streams, res

    srv, streams, res = asyncio.run(asyncio.wait_for(go(), TIMEOUT))
    assert isinstance(res[2], RetriesExhausted)
    assert streams[1].request.n_retries == 1
    assert len(res[0]) == len(res[1]) == NEW
    eng.finalize_trace()
    roots = validate_nesting(tracer.events)
    for rid in (0, 1, 2):
        assert roots[rid] == ["request"], rid

    def terminal(rid):
        ends = [e for e in tracer.events if e["rid"] == rid
                and e["ph"] == "E" and e["name"] == "request"]
        assert len(ends) == 1
        return (ends[0].get("args") or {}).get("status")

    assert [terminal(r) for r in (0, 1, 2)] \
        == ["finished", "finished", "failed"]
    names = {(e["rid"], e["name"], e["ph"]) for e in tracer.events}
    assert {(1, "quarantine", "I"), (1, "retry", "I"), (1, "prefill", "B"),
            (0, "decode", "B"), (None, "prefill_batch", "B"),
            (None, "decode_window", "B")} <= names
    assert (None, "fault:stall", "I") not in names
    n = len(tracer.events)
    eng.finalize_trace()                     # idempotent
    assert len(tracer.events) == n
    assert eng.n_quarantined == 3            # rid 1 once + rid 2 twice
    snap = srv.obs_snapshot()
    assert set(snap) == {"server", "engine", "latency"}
    assert snap["server"]["counters"]["server.retried"] == srv.n_retried == 2
    assert snap["server"]["counters"]["server.failed"] == srv.n_failed == 1
    assert snap["engine"] == eng.metrics.snapshot()
    assert snap["latency"]["n_requests"] == 2.0


def test_engine_counters_equal_registry_snapshot(models):
    eng = _engine(models, obs_interval=2)
    for p in _prompts(models[2].cfg.vocab):
        eng.add_request(p, NEW)
    out = eng.run()
    assert sum(len(v) for v in out.values()) == 3 * NEW
    snap = eng.metrics.snapshot()
    c, g = snap["counters"], snap["gauges"]
    assert c["engine.steps"] == eng.n_steps > 0
    assert c["engine.syncs"] == eng.n_syncs > 0
    assert c["engine.generated_tokens"] == eng.n_generated == 3 * NEW
    assert c["engine.prefill_tokens"] == eng.prefill_tokens_computed \
        == 7 + 12 + 9
    assert c["engine.quarantined"] == eng.n_quarantined == 0
    assert c["engine.phase_s"] == {f"phase={k}": v
                                   for k, v in eng.phase.items()}
    assert g["pages.peak_mapped"] == eng.peak_mapped_pages > 0
    assert snap["histograms"]["engine.window_steps"]["count"] == eng.n_syncs
    for name in ("mx.scale_bytes", "mx.poison_markers",
                 "mx.saturation_rate", "mx.clip_rate",
                 "mx.underflow_rate"):
        assert set(g[name]) == {"role=kv_key", "role=kv_value"}, name
    assert g["mx.poison_markers"] == {"role=kv_key": 0, "role=kv_value": 0}


def test_launcher_writes_trace_metrics_and_chrome(tmp_path, capsys):
    """The launcher's observability flags on the reduced model: a trace
    that validates, a Chrome file, and a metrics snapshot with the mx.*
    gauges; a kernel_fail plan stops with the engine's error."""
    from repro_torch.launch.serve import main as serve_main
    tr, ch, mj = (tmp_path / n for n in ("t.jsonl", "t.json", "m.json"))
    serve_main(["--arch", "chatglm3_6b", "--reduced", "--device", "cpu",
                "--paged", "--batch", "2", "--requests", "4",
                "--new-tokens", "6", "--quant", "kv=int8@32:ocp",
                "--faults", "prefill_nan:rid=1", "--obs-interval", "1",
                "--trace-out", str(tr), "--chrome-trace", str(ch),
                "--metrics-json", str(mj)])
    text = capsys.readouterr().out
    assert "fault tolerance: 1 quarantined" in text
    lines = [json.loads(x) for x in tr.read_text().splitlines()]
    assert lines[0]["schema"] == TRACE_SCHEMA
    assert lines[0]["meta"]["faults"] == "prefill_nan:rid=1"
    validate_nesting(lines[1:])
    assert json.loads(ch.read_text())["traceEvents"]
    snap = json.loads(mj.read_text())["metrics"]
    assert snap["counters"]["engine.quarantined"] == 1
    assert set(snap["gauges"]["mx.scale_bytes"]) \
        == {"role=kv_key", "role=kv_value"}
    for argv, msg in ((["--faults", "kernel_fail:nth=0"],
                       "no degraded path"),
                      (["--trace-out", "x"], "need --paged"),
                      (["--watchdog", "5"], "non-batch --arrival")):
        extra = [] if "need --paged" in msg else ["--paged"]
        with pytest.raises(SystemExit):
            serve_main(["--arch", "chatglm3_6b", "--reduced", "--device",
                        "cpu"] + extra + argv)
        assert msg in capsys.readouterr().err
