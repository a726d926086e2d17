"""Budget-constrained per-layer policy selection (mirrors
src/repro/calib/policy_search.py).

Given per-layer candidate sweeps (``repro_torch.calib.sweep``) and a byte
budget, pick the spec assignment maximizing quality and emit it as a
``core.spec.PolicyTable``.

The search is greedy marginal analysis: start every (role, layer) slot at
its highest-SQNR candidate, then — while the total cost exceeds the
budget — apply the single downgrade with the smallest quality loss per
byte saved (each slot's next option is the best-SQNR candidate among its
strictly cheaper ones).  Candidate lists are identical across layers, so
the search spends its budget where the calibration statistics say the
tensors are hardest to quantize, which is exactly the per-layer
sensitivity structure the OCP MX report observes.

Budget semantics (see README §Calibration & auto policies):

* serving (``search_kv_policy``)  — total KV-cache bytes per token
  position summed over all layers (codes + E8M0 scales, bit-packed when
  the spec says so): the unit ``serve.paging.kv_cache_token_nbytes``
  reports and the page pools actually allocate.
* training (``search_weights_policy``) — average bytes per weight
  parameter (element code bits + amortized scale, over 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.spec import PolicyTable, QuantPolicy, QuantSpec
from repro_torch.serve.paging import spec_side_nbytes

from repro_torch.calib.stats import CalibStats
from repro_torch.calib.sweep import (DEFAULT_CANDIDATES, ScoredSpec, sweep_role,
                               weight_param_nbytes)

Slot = Tuple[str, int]                       # (role, layer)


def parse_auto_budget(text: str) -> float:
    """Parse the ``auto:<budget>`` quantization-flag form; the budget is a
    positive float in the caller's byte unit (KV bytes/token for serving,
    bytes/param for training)."""
    if not isinstance(text, str) or not (text == "auto"
                                         or text.startswith("auto:")):
        raise ValueError(f"not an auto policy spec: {text!r}; expected "
                         f"'auto:<bytes>'")
    _, sep, rest = text.partition(":")
    if not sep or not rest:
        raise ValueError(
            f"auto policy {text!r} needs a byte budget: 'auto:<bytes>' "
            f"(e.g. 'auto:96' = 96 KV bytes per token across all layers)")
    try:
        budget = float(rest)
    except ValueError:
        raise ValueError(
            f"bad auto budget {rest!r} in {text!r}; expected a positive "
            f"number of bytes") from None
    if budget <= 0:
        raise ValueError(f"auto budget must be positive, got {budget!r}")
    return budget


@dataclasses.dataclass
class SearchResult:
    """The selected table plus its quality/cost accounting."""

    table: PolicyTable
    total_nbytes: float                       # in the budget's unit
    budget_nbytes: float
    mean_sqnr_db: float                       # over all chosen slots
    chosen: Dict[Slot, ScoredSpec]
    total_params: Optional[int] = None        # weights search only

    def describe(self) -> str:
        lines = [f"auto policy: {self.total_nbytes:.4g}B used of "
                 f"{self.budget_nbytes:.4g}B budget"
                 + (f" ({self.total_nbytes / self.total_params:.3f} "
                    f"B/param)" if self.total_params else "")
                 + f", mean SQNR {self.mean_sqnr_db:.1f}dB"]
        for (role, layer), s in sorted(self.chosen.items(),
                                       key=lambda kv: (kv[0][1], kv[0][0])):
            lines.append(f"  layer {layer:>2} {role:<9} -> {s}")
        return "\n".join(lines)


def _greedy_select(sweeps: Dict[str, Dict[int, List[ScoredSpec]]],
                   budget: float) -> Dict[Slot, ScoredSpec]:
    slots: Dict[Slot, List[ScoredSpec]] = {}
    for role, per_layer in sweeps.items():
        for layer, scored in per_layer.items():
            slots[(role, layer)] = scored
    if not slots:
        raise ValueError("nothing to search: empty sweep")
    choice: Dict[Slot, ScoredSpec] = {s: c[0] for s, c in slots.items()}
    floor = sum(min(c, key=lambda s: s.nbytes).nbytes
                for c in slots.values())
    if floor > budget:
        raise ValueError(
            f"budget {budget:.4g}B infeasible: even the cheapest "
            f"candidates need {floor:.4g}B "
            f"(raise the budget or widen the search space)")

    def total() -> float:
        return sum(s.nbytes for s in choice.values())

    while total() > budget:
        best: Optional[Tuple[float, Slot, ScoredSpec]] = None
        for slot, cands in slots.items():
            cur = choice[slot]
            cheaper = [c for c in cands if c.nbytes < cur.nbytes]
            if not cheaper:
                continue
            nxt = max(cheaper, key=lambda s: s.sqnr_db)
            rate = (cur.sqnr_db - nxt.sqnr_db) \
                / max(1e-9, cur.nbytes - nxt.nbytes)
            if best is None or rate < best[0]:
                best = (rate, slot, nxt)
        assert best is not None, "feasibility was checked above"
        choice[best[1]] = best[2]
    return choice


def _build_table(choice: Dict[Slot, ScoredSpec], n_layers: int,
                 base: QuantPolicy) -> PolicyTable:
    """Per-layer policies from the chosen specs, on top of ``base`` (whose
    untouched roles carry through); the most common layer policy becomes
    the table default so overrides stay minimal."""
    per_layer: List[QuantPolicy] = []
    for i in range(n_layers):
        kw = {role: s.spec for (role, layer), s in choice.items()
              if layer == i}
        per_layer.append(base.replace(**kw))
    counts: Dict[QuantPolicy, int] = {}
    for p in per_layer:
        counts[p] = counts.get(p, 0) + 1
    default = max(counts, key=counts.get)
    overrides = tuple((i, p) for i, p in enumerate(per_layer)
                      if p != default)
    return PolicyTable(default=default, overrides=overrides)


def _result(choice, table, budget) -> SearchResult:
    total = sum(s.nbytes for s in choice.values())
    mean_sqnr = sum(s.sqnr_db for s in choice.values()) / len(choice)
    return SearchResult(table=table, total_nbytes=total,
                        budget_nbytes=budget, mean_sqnr_db=mean_sqnr,
                        chosen=choice)


def search_kv_policy(stats: CalibStats, budget_bytes_per_token: float,
                     cfg, *,
                     candidates: Sequence[QuantSpec] = DEFAULT_CANDIDATES,
                     ) -> SearchResult:
    """Select per-layer ``kv_key``/``kv_value`` specs under a total
    KV-bytes-per-token budget (summed over every layer, K and V, codes +
    scales — the unit ``serve.paging.kv_cache_token_nbytes`` reports).

    Roles other than the two KV roles keep ``cfg.mx``'s values.  Raises
    ``ValueError`` when even the cheapest candidates overflow the budget.
    """
    n_kv, hd = cfg.n_kv_heads, cfg.hd
    cost = lambda spec: float(spec_side_nbytes(spec, n_kv, hd))
    sweeps = {role: sweep_role(stats, role, cost, candidates)
              for role in ("kv_key", "kv_value")}
    choice = _greedy_select(sweeps, budget_bytes_per_token)
    table = _build_table(choice, cfg.n_layers, cfg.mx)
    return _result(choice, table, budget_bytes_per_token)


def search_weights_policy(stats: CalibStats,
                          budget_bytes_per_param: float, cfg, *,
                          candidates: Sequence[QuantSpec]
                          = DEFAULT_CANDIDATES) -> SearchResult:
    """Select per-layer ``weights`` specs under an average
    bytes-per-parameter budget.

    Layers are charged by their actual parameter counts (from the
    calibration statistics), so a model mixing small dense layers with
    huge MoE layers cannot satisfy the budget on a per-layer average
    while blowing the true parameter-weighted one: ``total_nbytes`` /
    total params <= ``budget_bytes_per_param`` holds exactly."""
    swept = sweep_role(stats, "weights", weight_param_nbytes, candidates)
    layer_params = {layer: stats.role_layers("weights")[layer].count
                    for layer in swept}
    sweeps = {"weights": {
        layer: [dataclasses.replace(s, nbytes=s.nbytes
                                    * layer_params[layer])
                for s in scored]
        for layer, scored in swept.items()}}
    total_params = sum(layer_params.values())
    budget = budget_bytes_per_param * total_params
    choice = _greedy_select(sweeps, budget)
    table = _build_table(choice, cfg.n_layers, cfg.mx)
    res = _result(choice, table, budget)
    res.total_params = int(total_params)
    return res
