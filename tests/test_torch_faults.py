"""Fault injection and recovery in the port, against the JAX engine (mirrors
tests/test_serve_faults.py).

The fault plan is deterministic, so every recovery path can be held to a
result: the same seeded plan gives the same quarantine set, the same
``fired`` list and the same restored tokens.  Each engine drill runs one
scripted workload clean and under a ``FaultPlan`` on the port and on the
JAX engine (same weights, same plan text and seed, same rids), and holds
the port to the JAX engine's quarantine set and ``fired`` list and to its
tokens for every healthy request — which are also the clean run's: batch
rows are independent, so a poisoned neighbour must not perturb them.
Both sides run the reduced chatglm3-6b at its default ``attn_impl``
("dense"), as the reference's fault tests do.

The reference's ``kernel_fail`` site degrades a failed Pallas launch to
the dense path; the port has no degraded path (ROADMAP "No fallback"), so
a plan holding it is refused, and the combined drill runs the
reference's plan without it.  The async tests (retries recovered,
retries exhausted, the stalled-step watchdog) run on the port alone
against its clean run, each bounded by ``asyncio.wait_for``; the
watchdog cuts a 60 s stall after 3 s.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro_torch.core.formats import SCALE_NAN
from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.serve import (AsyncServer, ContinuousBatchingEngine, Fault,
                               FaultPlan, GenerationConfig, RetriesExhausted)
from repro_torch.serve.faults import (corrupt_swap_payload, poison_pool_pages,
                                      scrub_pool_pages)

torch.set_num_threads(1)

MIXED = "kv_key=int8@32:paper,kv_value=e4m3@32:paper"
PAGE = 8
NEW = 10
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params): the same random
    weights on both sides."""
    import jax
    from repro.models import Model as JModel
    from repro.models import load_reduced as j_load_reduced
    from repro.models.config import QuantPolicy as JPolicy
    from repro_torch.models.params import from_numpy
    from torch_parity import params_to_numpy
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(MIXED))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(MIXED))
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, from_numpy(params_to_numpy(jp), tcfg, "cpu")


def _prompts(vocab, lens=(7, 12, 9), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _kw(**kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 40)
    kw.setdefault("sync_every", 4)
    return dict(page_size=PAGE, **kw)


def _port(models, faults=None, **kw):
    _, _, tm, tp = models
    return ContinuousBatchingEngine(tm, tp, faults=faults, **_kw(**kw))


def _jax(models, faults=None, **kw):
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve import GenerationConfig as JGen
    jm, jp, _, _ = models
    return JEngine(jm, jp, faults=faults,
                   gen=JGen(max_new_tokens=NEW), **_kw(**kw))


def _plan(mod, text, seed):
    """The plan ``text`` under ``mod``'s FaultPlan (the two are separate
    classes with the same grammar)."""
    return mod.FaultPlan.parse(text, seed=seed)


def _serve(eng, prompts):
    for p in prompts:
        eng.add_request(p, NEW)
    return {r: v.tolist() for r, v in eng.run().items()}


def _failed(eng):
    return {r.rid: r.error for r in eng.scheduler.failed}


def _drill(models, text, seed, **kw):
    """The three-prompt workload under plan ``text`` on both engines, and
    clean on the port; returns (port engine, port plan, port tokens,
    clean tokens) after holding the port to the JAX engine."""
    import repro.serve.faults as jfaults
    import repro_torch.serve.faults as tfaults
    vocab = models[2].cfg.vocab
    prompts = _prompts(vocab)
    clean = _serve(_port(models, **kw), prompts)
    jplan = _plan(jfaults, text, seed)
    jeng = _jax(models, jplan, **kw)
    want = _serve(jeng, prompts)
    tplan = _plan(tfaults, text, seed)
    eng = _port(models, tplan, **kw)
    got = _serve(eng, prompts)
    assert tplan.fired == jplan.fired
    assert set(_failed(eng)) == set(_failed(jeng))
    assert got == want
    assert (eng.n_quarantined, eng.n_preemptions, eng.n_restores) \
        == (jeng.n_quarantined, jeng.n_preemptions, jeng.n_restores)
    for rid, toks in got.items():            # healthy rows: clean tokens
        assert toks == clean[rid], rid
    return eng, tplan, got, clean


# =============================================================================
# FaultPlan: parse / counting / rid targets / rng = the reference's
# =============================================================================
PLAN_TEXTS = ["prefill_nan:rid=2,page_corrupt:nth=1,stall:stall_s=0.5,"
              "kernel_fail:always",
              "page_corrupt:rid=7:nth=1,prefill_nan:rid=5:always,"
              "alloc_fail:nth=3,swap_corrupt:rid=1:n_bytes=8"]


@pytest.mark.parametrize("text", PLAN_TEXTS)
def test_fault_plan_matches_reference(text):
    """Parsing, ``nth`` / ``always`` / rid-target counting, ``fired`` and
    every ``rng`` draw equal the reference's over one consultation
    sequence."""
    import repro.serve.faults as jfaults
    import repro_torch.serve.faults as tfaults
    jp, tp = (m.FaultPlan.parse(text, seed=7) for m in (jfaults, tfaults))
    assert [vars(f) for f in tp.faults] == [vars(f) for f in jp.faults]
    rng = np.random.default_rng(3)
    for _ in range(60):
        site = tfaults.FaultPlan.SITES[int(rng.integers(6))]
        rid = None if rng.random() < 0.4 else int(rng.integers(8))
        a, b = jp.should_fire(site, rid), tp.should_fire(site, rid)
        assert (a is None) == (b is None)
        if a is not None:
            assert vars(a) == vars(b)
        assert jp.rng(site).integers(1 << 30, size=3).tolist() \
            == tp.rng(site).integers(1 << 30, size=3).tolist()
    assert tp.fired == jp.fired and tp.fired


def test_fault_plan_semantics():
    plan = FaultPlan([Fault("stall", nth=2)])
    assert [plan.should_fire("stall") is not None
            for _ in range(5)] == [False, False, True, False, False]
    assert plan.fired == [("stall", None, 2)]
    plan = FaultPlan([Fault("alloc_fail", always=True)])
    assert all(plan.should_fire("alloc_fail") for _ in range(3))
    plan = FaultPlan([Fault("prefill_nan", rid=7, nth=1)])
    assert plan.should_fire("prefill_nan", rid=3) is None
    assert plan.should_fire("prefill_nan", rid=7) is None
    assert plan.should_fire("prefill_nan", rid=7).rid == 7
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan.parse("page_corupt")
    with pytest.raises(ValueError, match="bad fault modifier"):
        FaultPlan.parse("stall:speed=9")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan([]).should_fire("nope")


# =============================================================================
# Corruption / scrub helpers: the reference's bytes, written in place
# =============================================================================
def _pools(policy):
    """A small layer-stacked pool of random bytes: (port pool, the same
    leaves as the reference's pool pytree)."""
    import jax.numpy as jnp
    from repro_torch.models.layers import init_paged_kv_cache
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(policy))
    pool = init_paged_kv_cache(cfg, 6, 4, 2, 64, "cpu", layers_dim=(2,))
    g = torch.Generator().manual_seed(1)
    for leaf in pool.values():
        if leaf.dtype == torch.uint8:
            leaf.copy_(torch.randint(0, 250, leaf.shape, generator=g,
                                     dtype=torch.uint8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g))
    jpool = {"layers": {k: jnp.asarray(v.float().numpy()
                                       if v.dtype == torch.bfloat16
                                       else v.numpy())
                        for k, v in pool.items()}}
    return pool, jpool


def _same(pool, jpool):
    for k, v in pool.items():
        want = np.asarray(jpool["layers"][k])
        np.testing.assert_array_equal(v.float().numpy() if v.dtype
                                      == torch.bfloat16 else v.numpy(),
                                      want, err_msg=k)


@pytest.mark.parametrize("policy", [MIXED, "kv=e2m1@32:ocp", "none"])
@pytest.mark.parametrize("offset", [None, 3])
def test_poison_and_scrub_match_reference(policy, offset):
    import repro.serve.faults as jfaults
    pool, jpool = _pools(policy)
    ptrs = {k: v.data_ptr() for k, v in pool.items()}
    out = poison_pool_pages(pool, [1, 4], offset=offset)
    assert out is pool and {k: v.data_ptr() for k, v in pool.items()} \
        == ptrs                                  # written in place
    jpool = jfaults.poison_pool_pages(jpool, [1, 4], offset=offset)
    _same(pool, jpool)
    scrub_pool_pages(pool, [1, 4])
    jpool = jfaults.scrub_pool_pages(jpool, [1, 4])
    _same(pool, jpool)
    assert all(not v[:, [1, 4]].any() for v in pool.values())


def test_poison_single_offset_hits_one_token():
    pool, _ = _pools(MIXED)
    for leaf in pool.values():
        leaf.zero_()
    poison_pool_pages(pool, [2], offset=3)
    ks = pool["ks_pages"]
    assert (ks[:, 2, 3] == SCALE_NAN).all() and ks[:, 2, :3].sum() == 0
    assert not pool["kc_pages"].any()            # codes are never touched


@pytest.mark.parametrize("policy", [MIXED, "none"])
def test_corrupt_swap_payload_matches_reference(policy):
    import repro.serve.faults as jfaults
    from repro_torch.serve.swap import gather_pages
    pool, jpool = _pools(policy)
    host, _ = gather_pages(pool, [2, 5])
    jhost = {"layers": {k: np.asarray(v)[:, [2, 5]]
                        for k, v in jpool["layers"].items()}}
    for v in jhost["layers"].values():
        v.setflags(write=False)          # gather_pages returns r/o views
    assert corrupt_swap_payload(host) == jfaults.corrupt_swap_payload(jhost)
    for k, v in host.items():
        got = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        np.testing.assert_array_equal(got, jhost["layers"][k], err_msg=k)


# =============================================================================
# Engine drills, site by site: the port = the JAX engine
# =============================================================================
def test_prefill_nan_quarantines_only_target(models):
    eng, plan, got, clean = _drill(models, "prefill_nan:rid=1:always", 1)
    failed = _failed(eng)
    assert set(failed) == {1} and "prefill" in failed[1]
    assert eng.n_quarantined == 1 and set(got) == {0, 2}
    assert plan.fired == [("prefill_nan", 1, 0)]


def test_page_corrupt_quarantined_mid_decode(models):
    eng, plan, got, _ = _drill(models, "page_corrupt:nth=2:rid=2", 2)
    failed = _failed(eng)
    assert set(failed) == {2}
    assert "poison" in failed[2] or "non-finite logits" in failed[2]
    assert ("page_corrupt", None, 2) in plan.fired
    assert set(got) == {0, 1}


def test_quarantined_request_retries_token_identical(models):
    """Same rid -> same sampling stream: a clean replay after
    ``retry_request`` emits the clean run's tokens, as the JAX engine's
    replay does."""
    import repro.serve.faults as jfaults
    import repro_torch.serve.faults as tfaults
    prompts = _prompts(models[2].cfg.vocab)
    clean = _serve(_port(models), prompts)
    outs = []
    for mod, make in ((jfaults, _jax), (tfaults, _port)):
        plan = mod.FaultPlan([mod.Fault("prefill_nan", rid=1, nth=0)],
                             seed=3)
        eng = make(models, plan)
        out = _serve(eng, prompts)
        assert set(_failed(eng)) == {1} and 1 not in out
        req = eng.scheduler.failed[0]
        eng.retry_request(req)
        out2 = {r: v.tolist() for r, v in eng.run().items()}
        assert not eng.scheduler.failed and req.n_retries == 1
        outs.append((out, out2, plan.fired))
    assert outs[0] == outs[1]
    out, out2, _ = outs[1]
    assert out2[1] == clean[1] and out[0] == clean[0] and out[2] == clean[2]


def test_alloc_fail_degrades_to_swap_out(models):
    """A failed page grant swaps the requesting slot out instead of
    crashing; the restore resumes with identical tokens."""
    eng, plan, got, clean = _drill(models, "alloc_fail:nth=1", 4,
                                   preempt=True)
    assert not eng.scheduler.failed
    assert eng.n_preemptions >= 1 and eng.n_restores == eng.n_preemptions
    assert plan.fired and plan.fired[0][0] == "alloc_fail"
    assert got == clean


def _swap_script(eng, vocab):
    """A low-priority victim mid-generation, then two urgent arrivals
    over two slots: the victim is swapped out."""
    rng = np.random.default_rng(3)
    victim = eng.add_request(
        rng.integers(1, vocab, size=9).astype(np.int32), 12, priority=5)
    eng.step()
    others = [eng.add_request(
        rng.integers(1, vocab, size=17).astype(np.int32), 6, priority=0)
        for _ in range(2)]
    return victim, others, {r: v.tolist() for r, v in eng.run().items()}


def test_swap_corrupt_detected_after_restore(models):
    import repro.serve.faults as jfaults
    import repro_torch.serve.faults as tfaults
    vocab = models[2].cfg.vocab
    v0, o0, clean = _swap_script(_port(models, max_slots=2, preempt=True),
                                 vocab)
    runs = []
    for mod, make in ((jfaults, _jax), (tfaults, _port)):
        plan = mod.FaultPlan([mod.Fault("swap_corrupt", rid=v0,
                                        always=True)], seed=5)
        eng = make(models, plan, max_slots=2, preempt=True)
        v, o, out = _swap_script(eng, vocab)
        assert (v, o) == (v0, o0) and eng.n_preemptions >= 1
        failed = _failed(eng)
        assert set(failed) == {v}
        assert "poison" in failed[v] or "non-finite logits" in failed[v]
        runs.append((out, plan.fired, eng.n_preemptions))
    assert runs[0] == runs[1]
    for r in o0:
        assert runs[1][0][r] == clean[r]


COMBINED = ("prefill_nan:rid=1:always,page_corrupt:nth=1:rid=2,"
            "stall:nth=0:stall_s=0.01")


def test_combined_plan_is_deterministic(models):
    """The reference's combined plan without ``kernel_fail``: the healthy
    request keeps its clean tokens, exactly the targets are quarantined,
    and a second run of the same plan text fires identically."""
    import repro_torch.serve.faults as tfaults
    eng, plan, got, clean = _drill(models, COMBINED, 9)
    assert set(_failed(eng)) == {1, 2} and got[0] == clean[0]
    assert {"prefill_nan", "page_corrupt", "stall"} \
        <= {s for s, _, _ in plan.fired}
    plan2 = _plan(tfaults, COMBINED, 9)
    eng2 = _port(models, plan2)
    got2 = _serve(eng2, _prompts(models[2].cfg.vocab))
    assert plan2.fired == plan.fired and got2 == got
    assert set(_failed(eng2)) == {1, 2}


def test_kernel_fail_plan_is_refused(models):
    """The port has no degraded path to recover through: a plan holding
    ``kernel_fail`` is refused before anything is built."""
    with pytest.raises(ValueError, match="no degraded path"):
        _port(models, FaultPlan.parse("kernel_fail:nth=1"))
    with pytest.raises(ValueError, match="no degraded path"):
        _port(models, FaultPlan.parse(COMBINED + ",kernel_fail:nth=0"))


# =============================================================================
# Async front end: retry budget, exhaustion, watchdog + snapshot restore
# =============================================================================
def _async(eng, prompts, **kw):
    async def go():
        out, errs = {}, {}
        async with AsyncServer(eng, **kw) as srv:
            streams = [await srv.submit(p, NEW) for p in prompts]
            for i, st in enumerate(streams):
                try:
                    out[i] = [int(t) for t in await st.tokens()]
                except (RetriesExhausted, RuntimeError) as e:
                    errs[i] = e
            return srv, out, errs

    return asyncio.run(asyncio.wait_for(go(), timeout=TIMEOUT))


def test_async_retry_recovers_quarantine(models):
    prompts = _prompts(models[2].cfg.vocab)
    clean = _serve(_port(models), prompts)
    plan = FaultPlan([Fault("prefill_nan", rid=1, nth=0)], seed=11)
    srv, out, errs = _async(_port(models, plan), prompts, retries=1,
                            retry_backoff_s=0.01)
    assert not errs and srv.n_retried == 1 and srv.n_failed == 0
    assert {i: out[i] for i in range(3)} == clean


def test_async_retries_exhausted_surfaces_error(models):
    prompts = _prompts(models[2].cfg.vocab)
    clean = _serve(_port(models), prompts)
    plan = FaultPlan([Fault("prefill_nan", rid=1, always=True)], seed=12)
    srv, out, errs = _async(_port(models, plan), prompts, retries=1,
                            retry_backoff_s=0.01)
    assert set(errs) == {1} and isinstance(errs[1], RetriesExhausted)
    assert srv.n_retried == 1 and srv.n_failed == 1
    assert out[0] == clean[0] and out[2] == clean[2]


def test_async_watchdog_recovers_stalled_step(models):
    """A hung step (a 60 s injected stall) is cut short by a 3 s
    watchdog, the engine restored from the last snapshot, and every
    stream still finishes with the clean run's tokens."""
    prompts = _prompts(models[2].cfg.vocab)
    clean = _serve(_port(models), prompts)
    plan = FaultPlan.parse("stall:nth=2:stall_s=60", seed=13)
    eng = _port(models, plan)
    srv, out, errs = _async(eng, prompts, use_executor=True, watchdog_s=3.0,
                            snapshot_every=1)
    assert not errs and srv.n_recoveries >= 1
    assert ("stall", None, 2) in plan.fired
    assert {i: out[i] for i in range(3)} == clean
    assert srv.metrics.counter("server.recoveries").value() \
        == srv.n_recoveries
