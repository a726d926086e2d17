"""The port's continuous engine against the JAX engine for every MX element
format in both modes (mirrors test_continuous_matches_solo_all_formats of
tests/test_serve_continuous.py).

Setup of that test: mixed prompt lengths, more requests than slots
(admission, eviction and slot reuse on the path), greedy decoding, K and V
of one format through the policy, the model's default ``attn_impl``
(dense decode attention over the dequantized pages, in both packages).
The reference's weights are carried across byte for byte, and the greedy
tokens must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro.serve import ContinuousBatchingEngine as JEngine
from repro_torch.core.formats import ALL_FORMATS
from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.models.params import from_numpy
from repro_torch.serve import ContinuousBatchingEngine
from torch_parity import params_to_numpy

torch.set_num_threads(1)

LENS = [4, 9, 14, 4, 9, 14, 9, 4]
NEW = 4
PAGE = 8
SLOTS = 4


def _serve(engine, prompts):
    rids = [engine.add_request(p, NEW) for p in prompts]
    out = engine.run()
    return [out[r].tolist() for r in rids]


@pytest.mark.parametrize("mode", ["ocp", "paper"])
@pytest.mark.parametrize("fmt", [f.name for f in ALL_FORMATS])
def test_continuous_matches_jax_all_formats(fmt, mode):
    policy = f"kv={fmt}@32:{mode}"
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(policy))
    tm = Model(tcfg, device="cpu")
    tp = from_numpy(params_to_numpy(jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n in LENS]
    kw = dict(max_slots=SLOTS, page_size=PAGE, max_len=max(LENS) + NEW + 1)
    # one decode-window shape and no health reductions keep the
    # reference's compile time down; neither changes its tokens
    want = _serve(JEngine(jm, jp, sync_every=1, health_checks=False, **kw),
                  prompts)
    eng = ContinuousBatchingEngine(tm, tp, **kw)
    assert _serve(eng, prompts) == want
    assert eng.n_generated == len(LENS) * NEW
