"""Prefix sharing + copy-on-write in the port: token identity and page safety
(mirrors tests/test_serve_prefix.py).

Turning the prefix cache on changes which pages are computed and stored,
never the tokens served: on the reduced chatglm3-6b, requests sharing a
system prompt get the same greedy tokens with ``prefix_cache`` on and off
(MX policies, mixed roles and an fp pool at ``attn_impl="dense"``), and
the port's prefix-on tokens equal the JAX engine's prefix-on tokens.  A
page's quantized bytes are a function of the token prefix, and the cold
MX prefill and the suffix prefill attend the same dequantized values
densely.  Also here: the trie on its own, the copy-on-write path, reclaim
safety, the scheduler's capacity gain and back-out, and quarantine of a
hit, which must scrub only the pages nobody else reads.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.serve import ContinuousBatchingEngine
from repro_torch.serve.paging import BlockManager
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler

torch.set_num_threads(1)

NEW = 4
PAGE = 8
SLOTS = 3          # < number of requests: waves + slot reuse on path
PREFIX_LEN = 19    # shared system prompt: 2 full pages + a partial
TAILS = [3, 7, 3, 7, 7, 3, 7, 3]
MIXED = "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=PREFIX_LEN).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, size=t)
                            .astype(np.int32)]) for t in TAILS]


def _model(policy, attn_impl="dense"):
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(policy),
                       attn_impl=attn_impl)
    model = Model(cfg, device="cpu")
    return model, model.init(seed=0, quantize=cfg.mx.weights is not None)


def _serve(model, params, prompts, prefix_cache, budgets=None, **kw):
    budgets = budgets or [NEW] * len(prompts)
    eng = ContinuousBatchingEngine(
        model, params, max_slots=SLOTS, page_size=PAGE,
        max_len=max(len(p) for p in prompts) + max(budgets) + 1,
        prefix_cache=prefix_cache, **kw)
    rids = [eng.add_request(p, b) for p, b in zip(prompts, budgets)]
    outs = eng.run()
    return eng, [outs[r].tolist() for r in rids]


# =============================================================================
# the trie on its own
# =============================================================================
def test_trie_lookup_insert_dedupe_and_lru():
    """Pages key under their parent chain; a repeat insert dedupes; an
    LRU leaf goes first; ``max_pages`` caps the pins."""
    bm = BlockManager(num_pages=12, page_size=4, max_slots=3,
                      max_pages_per_slot=4)
    pc = PrefixCache(bm, max_pages=3)
    a = np.arange(10, dtype=np.int32)              # 2 full pages + 2
    assert bm.allocate(0, 3)
    ids_a = bm.slot_page_ids(0)
    assert pc.insert(a, ids_a[:2]) == 2
    assert pc.lookup(a) == (ids_a[:2], 8)
    assert pc.lookup(a[:7]) == (ids_a[:1], 4)      # full pages only
    # a's second page under another first page is another node
    assert pc.lookup(np.concatenate([a[4:8], a[4:8]])) == ([], 0)
    assert bm.allocate(1, 2)
    assert pc.insert(a, bm.slot_page_ids(1)) == 0  # dedupe: no new pins
    assert all(bm.page_refcount(p) == 1 for p in bm.slot_page_ids(1))
    assert bm.allocate(2, 2)
    c, d = np.full(4, 99, np.int32), np.full(4, 77, np.int32)
    assert pc.insert(c, bm.slot_page_ids(2)[:1]) == 1   # 3 pins: the cap
    pc.lookup(a)                                   # a's chain is fresher
    assert pc.insert(d, bm.slot_page_ids(2)[1:]) == 1   # evicts leaf c
    assert pc.pinned_pages == 3
    assert pc.lookup(c) == ([], 0) and pc.lookup(a)[1] == 8
    assert pc.lookup(d)[1] == 4
    pc.record(8)
    pc.record(0)
    assert (pc.lookups, pc.hits, pc.tokens_matched) == (2, 1, 8)


# =============================================================================
# eviction safety: decref'd shared pages never recycle under a reader
# =============================================================================
def test_reclaim_never_recycles_mapped_pages():
    """Dropping a trie pin while another slot still maps the page must not
    return it to the free list; allocation can never hand it out again."""
    bm = BlockManager(num_pages=8, page_size=4, max_slots=2,
                      max_pages_per_slot=4)
    pc = PrefixCache(bm)
    tokens = np.arange(8, dtype=np.int32)         # 2 full pages
    assert bm.allocate(0, 2)
    ids = bm.slot_page_ids(0)
    assert pc.insert(tokens, ids) == 2
    bm.release(0)                                  # writer evicted: pinned
    pages, matched = pc.lookup(tokens)
    assert pages == ids and matched == 8
    assert bm.map_shared(1, pages)                 # reader slot maps them
    assert pc.reclaim(2) == 0                      # still table-mapped
    assert pc.pinned_pages == 0                    # pins are gone...
    assert all(bm.page_refcount(p) == 1 for p in ids)   # ...pages live
    assert bm.allocate(0, min(bm.free_pages, 4))
    assert not set(bm.slot_page_ids(0)) & set(ids)
    bm.release(1)                                  # last reader frees them
    assert all(bm.page_refcount(p) == 0 for p in ids)


# =============================================================================
# scheduler capacity: shared prefixes admit more from the same pool
# =============================================================================
def test_admission_capacity_improves_with_shared_prefix():
    """Same pool, same prompts: a warmed prefix cache turns per-request
    page demand from 3 private pages into 1, so admission goes from two
    concurrent requests to a full house."""
    prefix = np.arange(16, dtype=np.int32)         # 2 full pages

    def mk(with_prefix):
        bm = BlockManager(num_pages=8, page_size=8, max_slots=4,
                          max_pages_per_slot=3)
        pc = PrefixCache(bm) if with_prefix else None
        return bm, pc, Scheduler(max_slots=4, blocks=bm, prefix=pc)

    def traffic(sch, seed):
        rng = np.random.default_rng(seed)
        for rid in range(4):
            p = np.concatenate(
                [prefix, rng.integers(0, 1000, size=1).astype(np.int32)])
            sch.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW))

    bm, pc, sch = mk(True)
    warm = Request(rid=99, prompt=prefix.copy(), max_new_tokens=1)
    sch.submit(warm)
    assert sch.admit() == [warm]
    pc.insert(warm.prompt, bm.slot_page_ids(warm.slot)[:2])
    sch.evict(warm)                                # pages survive via pins
    traffic(sch, seed=4)
    admitted = sch.admit()
    assert len(admitted) == 4                      # full house
    assert all(r.matched_tokens == 16 for r in admitted)
    assert bm.shared_pages == 2                    # one canonical chain
    bm2, _, sch2 = mk(False)
    traffic(sch2, seed=4)
    assert len(sch2.admit()) == 2
    assert bm2.shared_pages == 0


def test_scheduler_backs_out_partial_admission():
    """When the pool can't cover a hit's private suffix even after
    reclaim, admission backs out the tentative shared mapping."""
    bm = BlockManager(num_pages=5, page_size=8, max_slots=2,
                      max_pages_per_slot=4)
    pc = PrefixCache(bm)
    sch = Scheduler(max_slots=2, blocks=bm, prefix=pc)
    warm = Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                   max_new_tokens=8)
    sch.submit(warm)
    assert sch.admit() == [warm]
    pc.insert(warm.prompt, bm.slot_page_ids(warm.slot)[:1])
    big = Request(rid=1, prompt=np.concatenate(
        [np.arange(8), np.arange(9)]).astype(np.int32), max_new_tokens=8)
    sch.submit(big)
    assert sch.admit() == []
    assert big.slot == -1
    assert bm.page_refcount(bm.slot_page_ids(warm.slot)[0]) == 1
    assert bm.mapped_pages == bm.slot_pages(warm.slot)
    assert pc.pinned_pages == 0


# =============================================================================
# token identity on the reduced model
# =============================================================================
@pytest.mark.parametrize("policy", [MIXED, "kv=int8@32:ocp",
                                    "kv=e2m1@32:ocp", "kv=e2m1@32:paper",
                                    "weights=e4m3@32:ocp", "none"])
def test_prefix_matches_off(policy):
    """Prefix-on == prefix-off: mixed roles, INT8, packed E2M1 (ocp and
    paper), and fp pools (MX weights, then fp weights) at
    ``attn_impl="dense"``, where the cold and the suffix prefill are both
    dense."""
    model, params = _model(policy)
    prompts = _prompts(model.cfg.vocab)
    eng_off, off = _serve(model, params, prompts, False)
    eng_on, on = _serve(model, params, prompts, True)
    assert on == off
    assert eng_on.prefix.hits > 0 and eng_on.n_hit_batches > 0
    assert eng_on.prefill_tokens_computed < eng_off.prefill_tokens_computed
    assert eng_on.peak_shared_pages >= 2
    assert 0 < eng_on.prefix_hit_rate < 1 and eng_off.prefix_hit_rate == 0


def test_fp_pool_at_flash_refuses_prefix_cache():
    """Over an fp pool at ``attn_impl="flash"`` the cold prefill attends
    through the flash kernel and the suffix prefill densely, so token
    identity is not promised there: the engine and the launcher refuse
    the prefix cache.  An MX pool at ``"flash"`` and an fp pool at
    ``"dense"`` take it, and an fp pool at ``"flash"`` serves without
    it."""
    from repro_torch.launch import serve as launcher
    fp, params = _model("weights=e4m3@32:ocp", "flash")
    with pytest.raises(ValueError, match="attn_impl='dense'"):
        ContinuousBatchingEngine(fp, params, max_slots=SLOTS,
                                 page_size=PAGE, max_len=32,
                                 prefix_cache=True)
    ContinuousBatchingEngine(fp, params, max_slots=SLOTS, page_size=PAGE,
                             max_len=32, prefix_cache=False)
    for policy, attn_impl in ((MIXED, "flash"), ("none", "dense")):
        model, params = _model(policy, attn_impl)
        eng = ContinuousBatchingEngine(model, params, max_slots=SLOTS,
                                       page_size=PAGE, max_len=32,
                                       prefix_cache=True)
        assert eng.prefix is not None
    with pytest.raises(ValueError, match="attn_impl='dense'"):
        launcher.main(["--arch", "chatglm3_6b", "--reduced", "--device",
                       "cpu", "--paged", "--weight-resident", "--batch",
                       "2", "--requests", "2", "--new-tokens", "2",
                       "--prompt-len", "8", "--prefix-cache",
                       "--quant", "weights=e4m3@32:ocp"])


def test_cow_forks_fire_and_stay_identical():
    """Fully cached page-aligned prompts fork the last shared page before
    recomputing the final position into it; the tokens still match the
    prefix-off engine."""
    model, params = _model("kv=int8@32:ocp")
    rng = np.random.default_rng(1)
    base = rng.integers(0, model.cfg.vocab, size=2 * PAGE).astype(np.int32)
    prompts = [base.copy() for _ in range(6)] + [np.concatenate(
        [base, rng.integers(0, model.cfg.vocab, size=3).astype(np.int32)])]
    eng_off, off = _serve(model, params, prompts, False)
    eng_on, on = _serve(model, params, prompts, True)
    assert on == off
    assert eng_on.n_cow_forks > 0 and eng_on.prefix.hits > 0
    assert eng_on.prefill_tokens_computed < eng_off.prefill_tokens_computed
    assert eng_off.n_cow_forks == 0


def test_engine_eviction_mid_window_keeps_identity():
    """Requests finishing at different steps while sharing pinned pages:
    evictions decref mid-run and the tokens still match prefix-off; the
    release insertion (prompt + output) publishes more pages than the
    prompts alone."""
    model, params = _model("kv=e4m3@32:ocp")
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, model.cfg.vocab, size=2 * PAGE).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, model.cfg.vocab, size=t).astype(np.int32)])
        for t in [1, 5, 9, 1, 5, 9]]
    budgets = [2, 6, 3, 5, 2, 4]                   # staggered finishes
    eng_off, off = _serve(model, params, prompts, False, budgets)
    eng_on, on = _serve(model, params, prompts, True, budgets)
    assert on == off
    assert eng_on.prefix.hits > 0


def test_release_insertion_serves_an_extended_conversation():
    """A prompt extending a finished request's prompt and output matches
    the pages published at its release (more than its prompt's full
    pages) and gets the prefix-off tokens."""
    model, params = _model(MIXED)
    rng = np.random.default_rng(3)
    first = rng.integers(0, model.cfg.vocab, size=13).astype(np.int32)
    tail = rng.integers(0, model.cfg.vocab, size=2).astype(np.int32)
    outs = []
    for pc in (False, True):
        eng = ContinuousBatchingEngine(model, params, max_slots=SLOTS,
                                       page_size=PAGE, max_len=48,
                                       prefix_cache=pc)
        r0 = eng.add_request(first, 8)
        got = eng.run()[r0]
        ext = np.concatenate([first, got, tail])
        r1 = eng.add_request(ext, NEW)
        outs.append((got.tolist(), eng.run()[r1].tolist()))
        if pc:
            # 13 + 7 fed-back tokens = 20 positions: 2 full pages
            assert eng.prefix.tokens_matched == 2 * PAGE
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["e4m3-weights/mixed-kv",
                                  "packed-e2m1-weights/int8-kv"])
def test_prefix_tokens_match_jax_engine(monkeypatch, name):
    """The port's prefix-on greedy tokens equal the JAX engine's
    prefix-on tokens (both at ``attn_impl="flash"``; the reference's
    matmul on its dequant-einsum path)."""
    import jax
    from repro.models import Model as JModel
    from repro.models import load_reduced as j_load_reduced
    from repro.models.config import QuantPolicy as JPolicy
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro_torch.models.params import from_numpy
    from torch_parity import params_to_numpy
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")
    policy = {"e4m3-weights/mixed-kv": "weights=e4m3@32:ocp," + MIXED,
              "packed-e2m1-weights/int8-kv":
                  "weights=e2m1@32:ocp,kv=int8@32:ocp"}[name]
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy),
                          attn_impl="flash")
    jm = JModel(jcfg)
    jp = jax.jit(jm.quantize_weights)(jm.init(jax.random.PRNGKey(0)))
    tcfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(policy),
                        attn_impl="flash")
    tm = Model(tcfg, device="cpu")
    tp = from_numpy(params_to_numpy(jp), tcfg, "cpu")
    prompts = _prompts(tcfg.vocab)
    kw = dict(max_slots=SLOTS, page_size=PAGE,
              max_len=max(len(p) for p in prompts) + NEW + 1,
              prefix_cache=True)
    # one decode-window shape and no health reductions keep the
    # reference's compile time down; neither changes its tokens
    jeng = JEngine(jm, jp, sync_every=1, health_checks=False, **kw)
    rids = [jeng.add_request(p, NEW) for p in prompts]
    jout = jeng.run()
    want = [jout[r].tolist() for r in rids]
    eng, got = _serve(tm, tp, prompts, True)
    assert got == want
    assert (eng.prefix.hits, eng.prefill_tokens_computed) \
        == (jeng.prefix.hits, jeng.prefill_tokens_computed)


# =============================================================================
# quarantine of a hit scrubs only the pages nobody else reads
# =============================================================================
def test_quarantined_hit_keeps_shared_pages():
    """A hit whose tail holds a token with a NaN embedding row is
    quarantined at its suffix prefill; its private pages are scrubbed,
    the shared prefix pages are not, and its neighbour on the same prefix
    gets the tokens it gets served alone."""
    model, params = _model(MIXED)
    params = dict(params, embed=params["embed"].clone())
    bad_tok = 7
    params["embed"][bad_tok] = float("nan")
    rng = np.random.default_rng(4)
    vocab = model.cfg.vocab

    def draw(n):
        x = rng.integers(0, vocab, size=n).astype(np.int32)
        return np.where(x == bad_tok, bad_tok + 1, x)

    prefix = draw(2 * PAGE + 3)
    warm, healthy, poisoned = (np.concatenate([prefix, draw(n)])
                               for n in (4, 5, 6))
    poisoned[-2] = bad_tok

    def engine():
        return ContinuousBatchingEngine(model, params, max_slots=SLOTS,
                                        page_size=PAGE, max_len=40,
                                        prefix_cache=True)

    solo = engine()
    solo.add_request(warm, NEW)
    solo.run()
    rid = solo.add_request(healthy, NEW)
    want = solo.run()[rid].tolist()
    eng = engine()
    eng.add_request(warm, NEW)
    eng.run()
    shared = eng.prefix.lookup(prefix)[0]
    assert len(shared) == 2
    before = {k: v[:, shared].clone() for k, v in eng.pool.items()}
    rh, rp = eng.add_request(healthy, NEW), eng.add_request(poisoned, NEW)
    out = eng.run()
    assert [r.rid for r in eng.scheduler.failed] == [rp]
    assert "health guard" in eng.scheduler.failed[0].error
    assert eng.prefix.hits == 2 and out[rh].tolist() == want
    for k, v in eng.pool.items():        # the shared pages kept their bytes
        assert torch.equal(v[:, shared], before[k]), k
    # a later hit on the same prefix still gets its tokens
    rid = eng.add_request(healthy, NEW)
    assert eng.run()[rid].tolist() == want
