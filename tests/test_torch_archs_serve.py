"""Both engines of the port against the JAX engines on every reduced GQA
decoder config of ``repro_torch.models.ARCH_IDS``: greedy tokens, and the
batch-dependence of MoE capacity routing.

Weight-resident e4m3 weights with INT8-key / E2M1-value MX KV at
``attn_impl="flash"`` on both sides (the reference's Pallas kernels in
interpret mode, its weight-resident matmul on the dequant-einsum path;
the port's kernels' plain versions).  Weights are carried across byte for
byte and prompts come from a numpy seed.  Tokens must be identical.

Capacity routing makes a token's output depend on the other tokens of
its group (ROADMAP C8): at decode the group is the whole slot batch,
idle and finished slots included, and a prefill's group is its bucket
batch.  At moonshot's capacity factor 1.25 the JAX engines keep none of
``sync_every`` 1 == 8 (with budgets that end inside a window), prefix
cache on == off, and so the port keeps none of them either: it gives the
JAX engine's tokens in each setting.  At the reference's no-drop factor
64.0 (tests/test_archs_smoke.py) the identities hold again.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import ServeEngine as JServe
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import ARCH_IDS, Model as TModel
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.params import from_numpy
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import GenerationConfig, ServeEngine
from torch_parity import params_to_numpy

torch.set_num_threads(1)

MIXED = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
MOE = "moonshot_v1_16b_a3b"
LENS = [4, 9, 14, 4, 9, 14, 9, 4]
NEW, PAGE, SLOTS = 4, 8, 4
B, S, NEW_STATIC = 2, 24, 6
# budgets that end inside an 8-step window, more requests than slots
VARIED = ([4, 9, 14, 4, 9, 14, 9, 4, 11, 6],
          [3, 7, 5, 9, 2, 6, 4, 8, 5, 3])


@pytest.fixture(autouse=True)
def einsum_matmul(monkeypatch):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")


def _pair(arch, **over):
    jcfg = j_load_reduced(arch, mx=JPolicy.parse(MIXED), attn_impl="flash",
                          **over)
    tcfg = t_load_reduced(arch, mx=TPolicy.parse(MIXED), attn_impl="flash",
                          **over)
    jm = JModel(jcfg)
    jp = jax.jit(jm.quantize_weights)(jm.init(jax.random.PRNGKey(0)))
    return jm, jp, TModel(tcfg, device="cpu"), from_numpy(
        params_to_numpy(jp), tcfg, "cpu")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(engine, prompts, news):
    rids = [engine.add_request(p, n) for p, n in zip(prompts, news)]
    out = engine.run()
    return [out[r].tolist() for r in rids]


def _continuous(jm, jp, tm, tp, prompts, news, sync_every, **kw):
    """(JAX tokens, port tokens) of one continuous-engine run each."""
    kw = dict(max_slots=SLOTS, page_size=PAGE, sync_every=sync_every,
              max_len=max(map(len, prompts)) + max(news) + 1, **kw)
    want = _serve(JEngine(jm, jp, health_checks=False, **kw), prompts, news)
    return want, _serve(TEngine(tm, tp, **kw), prompts, news)


# the GQA decoders (the other families' static engine:
# tests/test_torch_families_serve.py; they have no continuous engine)
GQA = tuple(a for a in ARCH_IDS if TModel(t_load_reduced(a), "cpu")
            .supports_paged())
CASES = [(a, {}) for a in GQA] + [(MOE, {"capacity_factor": 64.0})]


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[a + ("-nodrop" if o else "") for a, o in CASES])
def test_engines_tokens_match_jax(arch, over):
    """Continuous (admission, eviction, slot reuse) and static engines:
    the JAX engines' greedy tokens on the reduced config."""
    jm, jp, tm, tp = _pair(arch, **over)
    prompts = _prompts(tm.cfg.vocab, LENS)
    want, got = _continuous(jm, jp, tm, tp, prompts, [NEW] * len(LENS), 1)
    assert got == want
    tokens = np.random.default_rng(1).integers(
        0, tm.cfg.vocab, size=(B, S)).astype(np.int32)
    batch = {"tokens": tokens}
    want = JServe(jm, jp, max_len=S + 8).generate(
        batch, JGen(max_new_tokens=NEW_STATIC))
    got = ServeEngine(tm, tp, max_len=S + 8).generate(
        batch, GenerationConfig(max_new_tokens=NEW_STATIC))
    np.testing.assert_array_equal(got, want)


def test_moe_sync_every_follows_the_jax_engine():
    """Capacity 1.25: a finished slot rides out its window (its frozen
    token still routed) where sync_every=1 would have admitted a queued
    request, so the JAX engine's tokens differ between 1 and 8; the port
    gives the JAX tokens at each value."""
    jm, jp, tm, tp = _pair(MOE)
    prompts = _prompts(tm.cfg.vocab, VARIED[0])
    runs = {se: _continuous(jm, jp, tm, tp, prompts, VARIED[1], se)
            for se in (1, 8)}
    for se, (want, got) in runs.items():
        assert got == want, se
    assert runs[1][0] != runs[8][0]


def _prefix_prompts(vocab):
    rng = np.random.default_rng(2)
    shared = rng.integers(0, vocab, size=2 * PAGE).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, size=n).astype(
        np.int32)]) for n in (3, 7, 5, 9, 2, 6)]


def test_moe_prefix_cache_follows_the_jax_engine():
    """Capacity 1.25: a hit prefills only its suffix, so its tokens route
    in another group than a cold prefill's, and prefix cache on and off
    give other tokens in the JAX engine; the port gives the JAX tokens
    either way."""
    jm, jp, tm, tp = _pair(MOE)
    prompts = _prefix_prompts(tm.cfg.vocab)
    runs = {pc: _continuous(jm, jp, tm, tp, prompts, [NEW] * len(prompts),
                            1, prefix_cache=pc) for pc in (False, True)}
    for pc, (want, got) in runs.items():
        assert got == want, pc
    assert runs[False][0] != runs[True][0]


def test_moe_identities_hold_without_drops():
    """At the no-drop factor 64.0 the port keeps every identity of the
    dense configs: sync_every 1 == 8, prefix cache on == off, and the
    continuous engine gives the static engine's tokens."""
    tcfg = t_load_reduced(MOE, mx=TPolicy.parse(MIXED), attn_impl="flash",
                          capacity_factor=64.0)
    tm = TModel(tcfg, device="cpu")
    tp = tm.init(seed=0, quantize=True)
    kw = dict(max_slots=SLOTS, page_size=PAGE, max_len=32)
    prompts = _prompts(tcfg.vocab, VARIED[0])
    sync = [_serve(TEngine(tm, tp, sync_every=se, **kw), prompts, VARIED[1])
            for se in (1, 8)]
    assert sync[0] == sync[1]
    prompts = _prefix_prompts(tcfg.vocab)
    news = [NEW] * len(prompts)
    pre = [_serve(TEngine(tm, tp, prefix_cache=pc, **kw), prompts, news)
           for pc in (False, True)]
    assert pre[0] == pre[1]
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab, size=(SLOTS, 13)).astype(np.int32)
    static = ServeEngine(tm, tp, max_len=13 + 8).generate(
        {"tokens": tokens}, GenerationConfig(max_new_tokens=NEW_STATIC))
    cont = _serve(TEngine(tm, tp, **kw), list(tokens), [NEW_STATIC] * SLOTS)
    assert cont == static.tolist()
