"""The port's ContinuousBatchingEngine against the JAX one: greedy tokens.

Setup of tests/test_serve_continuous.py: mixed prompt lengths, more
requests than slots (admission, eviction and slot reuse on the path),
greedy decoding.  Both engines run at ``attn_impl="flash"``, the serving
setting: decode through the paged MX decode kernel (the reference's
Pallas kernel in interpret mode, the port's plain version on the CPU).
The reference's weights are carried across byte for
byte (``from_numpy``), and its weight-resident matmul runs the
dequant-einsum path (``REPRO_MX_MATMUL_IMPL=einsum``, bit-identical to its
fused kernel at these widths).  Tokens must be identical; a flip would
only be acceptable where the top-2 logit gap is below 1e-4, the decode
logits tolerance of tests/test_torch_model.py, and none occurs here.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro.serve import ContinuousBatchingEngine as JEngine
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import Model as TModel
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.params import from_numpy
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from torch_parity import params_to_numpy

torch.set_num_threads(1)

LENS = [4, 9, 14, 4, 9, 14, 9, 4]
NEW = 4
PAGE = 8
SLOTS = 4
POLICIES = {
    "e4m3-weights/mixed-kv":
        "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp",
    "packed-e2m1-weights/int8-kv": "weights=e2m1@32:ocp,kv=int8@32:ocp",
}


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _serve(engine, prompts):
    rids = [engine.add_request(p, NEW) for p in prompts]
    out = engine.run()
    return [out[r].tolist() for r in rids]


def _port(policy):
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy),
                          attn_impl="flash")
    jm = JModel(jcfg)
    jp = jax.jit(jm.quantize_weights)(jm.init(jax.random.PRNGKey(0)))
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy),
                          attn_impl="flash")
    tm = TModel(tcfg, device="cpu")
    return jm, jp, tm, from_numpy(params_to_numpy(jp), tcfg, "cpu")


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_engine_tokens_match_jax(monkeypatch, name):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")
    jm, jp, tm, tp = _port(POLICIES[name])
    prompts = _prompts(512)
    kw = dict(max_slots=SLOTS, page_size=PAGE, max_len=max(LENS) + NEW + 1)
    # one decode-window shape and no health reductions keep the
    # reference's compile time down; neither changes its tokens
    jeng = JEngine(jm, jp, sync_every=1, health_checks=False, **kw)
    want = _serve(jeng, prompts)
    eng = TEngine(tm, tp, **kw)
    got = _serve(eng, prompts)
    assert got == want
    assert eng.n_generated == len(LENS) * NEW
    assert (eng.kv_pool_nbytes, eng.weight_pool_nbytes) \
        == (jeng.kv_pool_nbytes, jeng.weight_pool_nbytes)


def test_sync_every_gives_identical_tokens():
    policy = POLICIES["e4m3-weights/mixed-kv"]
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy),
                          attn_impl="flash")
    tm = TModel(tcfg, device="cpu")
    tp = tm.init(seed=0, quantize=True)
    prompts = _prompts(512, seed=1)
    outs = []
    for se in (1, 8):
        eng = TEngine(tm, tp, max_slots=SLOTS, page_size=PAGE,
                      max_len=max(LENS) + NEW + 1, sync_every=se)
        outs.append(_serve(eng, prompts))
        assert eng.n_syncs >= 1
    assert outs[0] == outs[1]


def test_weight_pool_bytes_packed():
    """Packed E2M1 weights store 4.25 bits per weight (codes + scales);
    quantizing as ``init`` goes and afterwards gives the same bytes."""
    tcfg = t_load_reduced("chatglm3_6b",
                          mx=TPolicy.parse("weights=e2m1@32:ocp"))
    tm = TModel(tcfg, device="cpu")
    tp = tm.init(seed=0, quantize=True)
    after = tm.quantize_weights(tm.init(seed=0))
    for lq, la in zip(tp["layers"], after["layers"]):
        for blk in ("attn", "mlp"):
            for name, w in lq[blk].items():
                assert torch.equal(w.codes, la[blk][name].codes)
                assert torch.equal(w.scales, la[blk][name].scales)
    layer = tp["layers"][0]
    n_w = sum(w.k * w.n for blk in ("attn", "mlp")
              for w in layer[blk].values())
    n_b = sum(w.nbytes for blk in ("attn", "mlp")
              for w in layer[blk].values())
    assert n_b * 8 == n_w * 4.25
