"""Token identity with observability on (mirrors tests/test_obs_identity.py).

Tracing reuses the ``time.perf_counter`` stamps the engine already takes
and the MX-health sampler only reads the pool, so turning on the whole
observability stack — a shared metrics registry, per-request trace spans
and a health sample after every window (``obs_interval=1``) — must not
change a token.  The same seeded workload runs with observability off
and on, for every element format and the mixed per-role policy, and the
streams must be equal; the traced run's spans must nest, and the
``mx.*`` gauges must cover both KV roles with no poison marker.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.obs import MetricsRegistry, Tracer, validate_nesting
from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig

torch.set_num_threads(1)

PAGE = 8
NEW = 4
LENS = (5, 9, 6)

POLICIES = [
    "kv=int8@32:ocp",
    "kv=e4m3@32:ocp",
    "kv=e5m2@32:ocp",
    "kv=e3m2@32:ocp",
    "kv=e2m3@32:ocp",
    "kv=e2m1@32:ocp",
    "kv_key=int8@32:paper,kv_value=e4m3@32:paper",
]


def _serve(model, params, *, traced: bool):
    obs = {}
    if traced:
        obs = dict(metrics=MetricsRegistry(), tracer=Tracer(),
                   obs_interval=1)
    eng = ContinuousBatchingEngine(
        model, params, max_slots=2, page_size=PAGE,
        max_len=max(LENS) + NEW + 1, gen=GenerationConfig(), sync_every=2,
        **obs)
    rng = np.random.default_rng(11)
    for n in LENS:
        eng.add_request(rng.integers(1, model.cfg.vocab, size=n)
                        .astype(np.int32), NEW)
    return eng, {r: v.tolist() for r, v in eng.run().items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_tokens_identical_with_observability_on(policy):
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(policy))
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    _, want = _serve(model, params, traced=False)
    eng, out = _serve(model, params, traced=True)
    assert out == want
    eng.finalize_trace()
    roots = validate_nesting(eng.tracer.events)
    for rid in out:
        assert roots[rid] == ["request"], rid
    snap = eng.metrics.snapshot()
    assert snap["counters"]["engine.generated_tokens"] == len(LENS) * NEW
    g = snap["gauges"]
    assert set(g["mx.saturation_rate"]) == {"role=kv_key", "role=kv_value"}
    assert g["mx.poison_markers"] == {"role=kv_key": 0, "role=kv_value": 0}
    assert all(v > 0 for v in g["mx.scale_bytes"].values())
