"""The port's static ``ServeEngine`` against the JAX one, and the port's
continuous engine against its static engine: greedy tokens.

Setup of tests/test_serve.py (B=2, S=24, 6 new tokens) with weight-resident
e4m3 weights and either an INT8-key / E2M1-value MX cache (decode through
the contiguous MX decode kernel) or an fp cache (prefill through the flash
kernel); the reference runs at ``attn_impl="flash"``, so it reaches its
Pallas kernels (interpret mode), with its weight-resident matmul on the
dequant-einsum path (``REPRO_MX_MATMUL_IMPL=einsum``, bit-identical to its
fused kernel at these widths).  Weights are carried across byte for byte
(``from_numpy``) and prompts come from a numpy seed.  Tokens must be
identical; a flip would only be acceptable where the top-2 logit gap is
below 1e-4, the decode logits tolerance of tests/test_torch_model.py, and
none occurs here.  The second test is the solo-oracle setup of
tests/test_serve_continuous.py, on the port alone.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro.serve import GenerationConfig as JGen
from repro.serve import ServeEngine as JServe
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import Model as TModel
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.params import from_numpy
from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
from repro_torch.serve import ServeEngine
from torch_parity import params_to_numpy

torch.set_num_threads(1)

B, S, NEW_STATIC = 2, 24, 6
MIXED = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
POLICIES = {"e4m3-weights/mixed-kv": MIXED,
            "e4m3-weights/fp-kv": "weights=e4m3@32:ocp"}
# tests/test_serve_continuous.py: mixed lengths, more requests than slots
LENS = [4, 9, 14, 4, 9, 14, 9, 4]
NEW, PAGE, SLOTS = 4, 8, 4


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_static_engine_tokens_match_jax(monkeypatch, name):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")
    policy = POLICIES[name]
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy),
                          attn_impl="flash")
    jm = JModel(jcfg)
    jp = jax.jit(jm.quantize_weights)(jm.init(jax.random.PRNGKey(0)))
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy))
    tm = TModel(tcfg, device="cpu")
    tp = from_numpy(params_to_numpy(jp), tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, size=(B, S))
    batch = {"tokens": tokens.astype(np.int32)}
    want = JServe(jm, jp, max_len=S + 8).generate(
        batch, JGen(max_new_tokens=NEW_STATIC))
    eng = ServeEngine(tm, tp, max_len=S + 8)
    got = eng.generate(batch, GenerationConfig(max_new_tokens=NEW_STATIC))
    assert got.shape == (B, NEW_STATIC) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert eng.weight_pool_nbytes == JServe(jm, jp, S + 8).weight_pool_nbytes
    cache = tm.init_cache(B, S + 8)
    assert eng.kv_cache_nbytes == sum(t.numel() * t.element_size()
                                      for t in cache.values())
    with pytest.raises(NotImplementedError):
        eng.generate(batch, GenerationConfig(temperature=0.7))


def test_continuous_matches_static_solo():
    """Every request served through the continuous engine gets the tokens
    the static engine gives it served alone."""
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(MIXED))
    tm = TModel(tcfg, device="cpu")
    tp = tm.init(seed=0, quantize=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n in LENS]
    eng = ContinuousBatchingEngine(tm, tp, max_slots=SLOTS, page_size=PAGE,
                                   max_len=max(LENS) + NEW + 1)
    rids = [eng.add_request(p, NEW) for p in prompts]
    outs = eng.run()
    solos = {}
    for rid, p in zip(rids, prompts):
        n = len(p)
        solos.setdefault(n, ServeEngine(tm, tp, max_len=n + NEW + 2))
        ref = solos[n].generate({"tokens": p[None]},
                                GenerationConfig(max_new_tokens=NEW))[0]
        assert outs[rid].tolist() == ref.tolist()
