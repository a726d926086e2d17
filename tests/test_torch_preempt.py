"""Preempt-and-swap in the port: token identity against the JAX engine, SLO
admission order, and the swap store (mirrors tests/test_serve_preempt.py).

Every scenario runs one deterministic script: a batch-class request
(priority 1) is mid-generation when an interactive one (priority 0)
arrives that cannot fit beside it in a tight pool, so the batch request's
packed KV pages swap to the host and come back on re-admission.  The
script runs on the port over the tight pool and over a large one (no
preemption), and on the JAX engine over the tight pool — same submission
order, same rids.  Greedy tokens must agree bit for bit across all three,
and the preemption / restore counts and swap bytes must equal the JAX
engine's (the pool leaves have the reference's shapes and dtypes).  Both
sides run the reduced chatglm3-6b with the same weights; the reference
runs its kernels as its own tests do (Pallas interpret mode on the CPU).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.serve import (BlockManager, ContinuousBatchingEngine,
                               GenerationConfig, HostSwapStore, PageGrantError,
                               Request, Scheduler, SwapData)
from repro_torch.serve.paging import TRASH_PAGE, pages_needed
from repro_torch.serve.swap import (concat_snapshots, gather_pages,
                                    scatter_pages)

torch.set_num_threads(1)

MIXED = "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
PAGE = 8
MAX_LEN = 30
B_NEW = 20          # batch request: 9-token prompt -> 4 reserved pages
A_NEW = 4           # interactive: 17-token prompt -> 3 reserved pages
TIGHT, LARGE = 6, 32

# name -> (policy, attn_impl, prefix cache)
CASES = {"mixed-int8-e2m1": (MIXED, "flash", False),
         "e3m2-ocp": ("kv=e3m2@32:ocp", "flash", False),
         "fp-pool": ("none", "dense", False),
         "prefix-cache": (MIXED, "flash", True)}


def _models(policy, attn_impl):
    """(JAX model, JAX params, port model, port params): the same random
    weights on both sides."""
    import jax
    from repro.models import Model as JModel
    from repro.models import load_reduced as j_load_reduced
    from repro.models.config import QuantPolicy as JPolicy
    from repro_torch.models.params import from_numpy
    from torch_parity import params_to_numpy
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy),
                          attn_impl=attn_impl)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(policy),
                        attn_impl=attn_impl)
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, from_numpy(params_to_numpy(jp), tcfg, "cpu")


def _traffic(vocab, warm=False):
    rng = np.random.default_rng(3)
    pb = rng.integers(1, vocab, size=9).astype(np.int32)
    pa = rng.integers(1, vocab, size=17).astype(np.int32)
    w = None
    if warm:                    # both prompts open with a cached page
        w = np.random.default_rng(11).integers(1, vocab, size=PAGE) \
            .astype(np.int32)
        pb[:PAGE] = w
        pa[:PAGE] = w
    return pb, pa, w


def _drive(eng, pb, pa, warm=None):
    """The eviction script: returns (batch rid, interactive rid, tokens)."""
    if warm is not None:
        eng.add_request(warm, 1)
        eng.run()
        eng.reset_metrics()
    rb = eng.add_request(pb, B_NEW, priority=1)
    req_b = next(r for r in eng.scheduler.waiting if r.rid == rb)
    while len(req_b.out) < 5:            # the batch request decodes
        eng.step()
    ra = eng.add_request(pa, A_NEW, priority=0, deadline_s=1.0)
    out = eng.run()
    return rb, ra, {r: out[r].tolist() for r in (rb, ra)}


def _port(model, params, num_pages, *, temperature=0.0, prefix=False):
    return ContinuousBatchingEngine(
        model, params, max_slots=2, page_size=PAGE, max_len=MAX_LEN,
        num_pages=num_pages, gen=GenerationConfig(temperature=temperature),
        sync_every=4, prefix_cache=prefix, preempt=True)


def _check_swapped_and_back(eng):
    assert eng.n_preemptions >= 1, "the script failed to force eviction"
    assert eng.n_restores == eng.n_preemptions
    assert eng.scheduler.n_preemptions == eng.n_preemptions
    st = eng.swap_store
    assert st.bytes_in == st.bytes_out > 0
    assert len(st) == 0                  # every swap-out was restored
    assert eng.phase["swap"] > 0.0


# =============================================================================
# token identity: port tight = port large = JAX tight
# =============================================================================
@pytest.mark.parametrize("case", sorted(CASES))
def test_preempt_tokens_match_jax_engine(monkeypatch, case):
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve import GenerationConfig as JGen
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")
    policy, attn_impl, prefix = CASES[case]
    jm, jp, tm, tp = _models(policy, attn_impl)
    pb, pa, warm = _traffic(tm.cfg.vocab, warm=prefix)
    tight = _port(tm, tp, TIGHT, prefix=prefix)
    rb, ra, got = _drive(tight, pb, pa, warm)
    _check_swapped_and_back(tight)
    large = _port(tm, tp, LARGE, prefix=prefix)
    assert _drive(large, pb, pa, warm) == (rb, ra, got)
    assert large.n_preemptions == 0
    assert len(got[rb]) == B_NEW and len(got[ra]) == A_NEW
    # the reference over the tight pool; no health reductions keep its
    # compile time down without changing its tokens
    jeng = JEngine(jm, jp, max_slots=2, page_size=PAGE, max_len=MAX_LEN,
                   num_pages=TIGHT, gen=JGen(max_new_tokens=B_NEW),
                   sync_every=4, prefix_cache=prefix, preempt=True,
                   health_checks=False)
    assert _drive(jeng, pb, pa, warm) == (rb, ra, got)
    assert (tight.n_preemptions, tight.n_restores) \
        == (jeng.n_preemptions, jeng.n_restores)
    assert (tight.swap_store.bytes_out, tight.swap_store.bytes_in) \
        == (jeng.swap_store.bytes_out, jeng.swap_store.bytes_in)
    jleaves = jeng.pool["layers"]
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jleaves.items()} \
        == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tight.pool.items()}
    if prefix:
        assert tight.prefix.hits == jeng.prefix.hits >= 2
        bm = tight.blocks
        assert bm.free_pages + bm.live_pages == TIGHT - 1


def test_preempt_sampled_tokens_identical():
    """T 0.8 (port only): the slot's sampling key is saved at swap-out and
    written back at re-admission, so the sampled continuation is the one
    of a run without the preemption."""
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(MIXED),
                       attn_impl="flash")
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    pb, pa, _ = _traffic(cfg.vocab)
    tight = _port(model, params, TIGHT, temperature=0.8)
    got = _drive(tight, pb, pa)
    _check_swapped_and_back(tight)
    large = _port(model, params, LARGE, temperature=0.8)
    assert _drive(large, pb, pa) == got
    assert large.n_preemptions == 0


@pytest.mark.parametrize("where", ["plan_window", "first_decode_page"])
def test_failed_grant_swaps_the_slot_out(monkeypatch, where):
    """A page grant that fails although admission reserved it (an
    allocator fault) raises ``PageGrantError`` in ``plan_window``, or
    fails the first decode page at the end of a prefill; either way the
    engine swaps that request out and it resumes with the tokens of an
    undisturbed run (no preemption setting needed)."""
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(MIXED))
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(5)
    # a 16-token prompt fills two pages: its first decode write needs a
    # third (the first-decode grant); 17 tokens in decode cross into it
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (16, 11)]

    fired = []

    def serve(fault):
        eng = ContinuousBatchingEngine(model, params, max_slots=2,
                                       page_size=PAGE, max_len=40,
                                       sync_every=4)
        if fault:
            ensure = eng.blocks.ensure

            def failing(slot, n):
                grows = pages_needed(n, PAGE) > eng.blocks.slot_pages(slot)
                # n == 17: the 16-token prompt's first decode page
                if grows and not fired \
                        and (n == 17) == (where == "first_decode_page"):
                    fired.append(slot)
                    return False
                return ensure(slot, n)

            monkeypatch.setattr(eng.blocks, "ensure", failing)
        rids = [eng.add_request(p, 12) for p in prompts]
        out = eng.run()
        return eng, [out[r].tolist() for r in rids]

    eng, got = serve(True)
    assert len(fired) == 1
    assert eng.n_preemptions == eng.n_restores == 1
    assert eng.swap_store.bytes_in == eng.swap_store.bytes_out > 0
    assert serve(False)[1] == got


def test_plan_window_raises_page_grant_error():
    bm = BlockManager(num_pages=4, page_size=4, max_slots=1,
                      max_pages_per_slot=4)
    sched = Scheduler(1, bm)
    sched.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=8))
    [req] = sched.admit()
    bm.ensure = lambda slot, n: False    # an allocator fault
    with pytest.raises(PageGrantError) as e:
        sched.plan_window(np.array([4], np.int32), sync_every=4)
    # a window of 4 writes up to position 8: 3 pages, 1 held
    assert (e.value.slot, e.value.need) == (0, 2)


# =============================================================================
# SLO admission order = the reference scheduler's
# =============================================================================
def _admit_order(mod, reqs, slots):
    """Rids in the order ``mod``'s Scheduler admits ``reqs`` through
    ``slots`` slots, each admitted wave evicted before the next."""
    bm = mod.BlockManager(num_pages=64, page_size=8, max_slots=slots,
                          max_pages_per_slot=4)
    sched = mod.Scheduler(slots, bm)
    for rid, (prio, dl, t) in enumerate(reqs):
        sched.submit(mod.Request(rid=rid, prompt=np.arange(
            5 + rid % 7, dtype=np.int32), max_new_tokens=4, priority=prio,
            deadline_s=dl, arrival_t=t))
    order = []
    while sched.waiting:
        wave = sched.admit()
        order += [r.rid for r in wave]
        for r in wave:
            sched.evict(r)
    return order


@pytest.mark.parametrize("slots", [1, 3])
def test_slo_admission_order_matches_reference(slots):
    import repro.serve as jserve
    import repro_torch.serve as tserve
    rng = np.random.default_rng(7)
    reqs = [(int(rng.integers(0, 3)),
             None if rng.random() < 0.3 else float(rng.uniform(0.05, 2.0)),
             float(rng.uniform(0.0, 1.0))) for _ in range(24)]
    want = _admit_order(jserve, reqs, slots)
    assert _admit_order(tserve, reqs, slots) == want
    assert want != list(range(24))       # the queue really reorders


def test_default_class_admits_fifo():
    import repro_torch.serve as tserve
    reqs = [(0, None, float(t)) for t in
            np.random.default_rng(2).uniform(0, 1, size=12)]
    assert _admit_order(tserve, reqs, 2) == list(range(12))


def test_pick_victim_youngest_least_important():
    """Preemption needs a strictly lower-priority runner; the youngest of
    the least important class goes; nothing is preempted while the head
    fits."""
    bm = BlockManager(num_pages=10, page_size=4, max_slots=3,
                      max_pages_per_slot=4)
    sched = Scheduler(3, bm)
    for rid, prio in enumerate([1, 2, 2]):
        sched.submit(Request(rid=rid, prompt=np.arange(8, dtype=np.int32),
                             max_new_tokens=4, priority=prio))
    assert [r.rid for r in sched.admit()] == [0, 1, 2]
    assert sched.pick_victim() is None   # nothing waits
    sched.submit(Request(rid=3, prompt=np.arange(8, dtype=np.int32),
                         max_new_tokens=4, priority=2))
    assert sched.pick_victim() is None   # no strictly lower class runs
    sched.submit(Request(rid=4, prompt=np.arange(8, dtype=np.int32),
                         max_new_tokens=4, priority=0))
    victim = sched.pick_victim()
    assert victim.rid == 2
    victim.swap_pages = bm.slot_pages(victim.slot)
    sched.preempt(victim)
    assert [r.rid for r in sched.waiting] == [4, 2, 3]
    assert victim.n_preemptions == 1 and sched.n_preemptions == 1
    assert [r.rid for r in sched.admit()] == [4]
    assert not sched.can_admit_now(np.arange(4), 4)


# =============================================================================
# the swap store
# =============================================================================
def _pool(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"kc_pages": torch.randint(0, 256, (2, 6, 4, 2, 3), generator=g,
                                      dtype=torch.uint8),
            "vs_pages": torch.randn((2, 6, 4, 2, 1), generator=g,
                                    dtype=torch.float32)}


def test_gather_scatter_round_trip_matches_reference():
    """Pages move verbatim on the page axis (1) of layer-stacked leaves,
    as the reference's ``gather_pages`` moves them; a scatter lands only
    on its target pages, in place."""
    from repro.serve.swap import gather_pages as j_gather
    pool = _pool()
    host, nbytes = gather_pages(pool, [2, 5])
    jhost, jbytes = j_gather({k: v.numpy() for k, v in pool.items()},
                             [2, 5])
    assert nbytes == jbytes == sum(v.nbytes for v in jhost.values())
    for k in pool:
        assert host[k].shape[1] == 2
        np.testing.assert_array_equal(host[k].numpy(), jhost[k])
    zero = {k: torch.zeros_like(v) for k, v in pool.items()}
    leaves = dict(zero)
    assert scatter_pages(zero, [1, 3], host) is zero
    for k in pool:
        assert zero[k] is leaves[k]      # the live leaves, written in place
        assert torch.equal(zero[k][:, [1, 3]], pool[k][:, [2, 5]])
        assert not zero[k][:, [0, 2, 4, 5]].any()


def test_concat_snapshots_matches_single_gather():
    pool = _pool(1)
    s1, _ = gather_pages(pool, [0])
    s2, _ = gather_pages(pool, [2, 3])
    cat = concat_snapshots([s1, s2])
    want, _ = gather_pages(pool, [0, 2, 3])
    for k in pool:
        assert torch.equal(cat[k], want[k])
    assert concat_snapshots([s1]) is s1


def _data(nbytes=64):
    return SwapData(pages={"x": torch.zeros(nbytes, dtype=torch.uint8)},
                    n_pages=1, length=8, key=torch.zeros(2, dtype=torch.int64),
                    nbytes=nbytes)


def test_swap_store_accounting():
    st = HostSwapStore()
    st.put(1, _data(64))
    st.put(2, _data(32))
    assert len(st) == 2 and 1 in st and 3 not in st
    assert (st.bytes_out, st.bytes_in) == (96, 0)
    assert st.resident_bytes == st.peak_resident_bytes == 96
    assert st.pop(1).nbytes == 64
    assert st.bytes_in == 64 and st.resident_bytes == 32
    assert st.peak_resident_bytes == 96  # the peak is sticky
    with pytest.raises(ValueError, match="already resident"):
        st.put(2, _data())
    with pytest.raises(KeyError, match="not resident"):
        st.pop(8)
    assert len(st) == 1                  # failed calls change nothing
    st.reset_counters()                  # a measurement window starts
    assert (st.bytes_out, st.bytes_in) == (0, 0)
    assert st.peak_resident_bytes == 32  # re-anchored to the residents
    assert st.pop(2).nbytes == 32        # the entry survived the reset


def test_swap_out_snapshots_then_releases():
    bm = BlockManager(8, PAGE, 2, 4)
    assert bm.allocate(0, 2)
    ids = bm.slot_page_ids(0)
    assert bm.map_shared(0, [ids[0]])    # logical row: p0, p1, p0 (shared)
    v = bm.version
    row = bm.swap_out(0)
    assert row == [(ids[0], False), (ids[1], False), (ids[0], True)]
    assert bm.slot_pages(0) == 0 and bm.version == v + 1
    assert (bm.tables[0] == TRASH_PAGE).all()
    assert bm.page_refcount(ids[0]) == 0
    assert bm.free_pages == 7 and bm.can_allocate(7)
    assert not bm.can_allocate(8)


def test_swap_out_keeps_pinned_and_shared_pages_live():
    bm = BlockManager(8, PAGE, 2, 4)
    assert bm.allocate(0, 2)
    ids = bm.slot_page_ids(0)
    bm.pin(ids[0])                       # the trie holds page 0
    assert bm.map_shared(1, [ids[1]])    # another slot reads page 1
    row = bm.swap_out(0)
    assert row == [(ids[0], False), (ids[1], False)]
    assert bm.page_refcount(ids[0]) == 1     # the pin outlives swap-out
    assert bm.page_refcount(ids[1]) == 1     # the reader is unaffected
    assert bm.slot_page_ids(1) == [ids[1]]
    assert bm.free_pages == 5
    bm.unpin(ids[0])
    assert bm.page_refcount(ids[0]) == 0 and bm.free_pages == 6
