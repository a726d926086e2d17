"""repro_torch.calib: activation-statistics calibration and the
budget-constrained choice of a per-layer quantization policy (mirrors
src/repro/calib).

``stats``         — run calibration batches through the instrumented
                    forward (``Model.forward_calib``) and accumulate, per
                    tensor role and layer, streaming statistics (absmax,
                    moments, the biased-exponent histogram) and a bounded
                    block sample of the raw values; the reductions run on
                    the tensors' device.
``sweep``         — score every candidate ``QuantSpec`` on those samples
                    (SQNR, block-relative error) beside its storage cost.
``policy_search`` — pick, under a byte budget, the per-layer assignment
                    of best quality, as a ``core.spec.PolicyTable``
                    (applied with ``models.config.apply_policy_table``).
"""
from repro_torch.calib.stats import (  # noqa: F401
    CalibStats, TensorStats, collect_model_stats,
)
from repro_torch.calib.sweep import (  # noqa: F401
    DEFAULT_CANDIDATES, ScoredSpec, score_sample, sweep_role,
    weight_param_nbytes,
)
from repro_torch.calib.policy_search import (  # noqa: F401
    SearchResult, parse_auto_budget, search_kv_policy,
    search_weights_policy,
)
