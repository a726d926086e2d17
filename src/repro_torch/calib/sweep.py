"""Candidate-spec sweep: score every ``QuantSpec`` of a search space on
the collected calibration samples (mirrors src/repro/calib/sweep.py).

Quality comes from ``core.metrics``: the SQNR of the quantize-dequantize
round trip and the block-relative max error, on each (role, layer)'s
block sample (plain torch on the host, as the reference scores in jnp);
cost from the spec's storage layout through the caller's per-unit cost
function (KV bytes per token through ``serve.paging.spec_side_nbytes``,
bytes per parameter for weights).

The default search space is the paper's six element formats at the
kernels' block of 32 in OCP mode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.calib.stats import CalibStats
from repro_torch.core.convert import quantize_dequantize
from repro_torch.core.formats import DEFAULT_BLOCK, SCALE_BITS, get_format
from repro_torch.core.metrics import max_rel_err_vs_blockmax, sqnr_db
from repro_torch.core.spec import QuantSpec

DEFAULT_CANDIDATES = tuple(
    QuantSpec(f, "ocp", DEFAULT_BLOCK)
    for f in ("int8", "e4m3", "e5m2", "e3m2", "e2m3", "e2m1"))


def weight_param_nbytes(spec: QuantSpec) -> float:
    """Bytes one weight parameter costs under ``spec``: element code bits
    plus the shared scale amortized over the block."""
    f = get_format(spec.fmt)
    bits = f.code_bits if spec.packed else 8
    return (bits + SCALE_BITS / spec.block) / 8.0


@dataclasses.dataclass(frozen=True)
class ScoredSpec:
    """One candidate's quality and cost on one (role, layer) sample."""

    spec: QuantSpec
    sqnr_db: float
    max_rel_err: float
    nbytes: float          # per role unit (token or parameter)

    def __str__(self) -> str:
        return (f"{self.spec} sqnr={self.sqnr_db:.1f}dB "
                f"mre={self.max_rel_err:.3g} {self.nbytes:.4g}B")


def score_sample(sample: np.ndarray, spec: QuantSpec) -> Dict[str, float]:
    """Quality of quantizing ``sample`` ((rows, block) f32) under
    ``spec``: SQNR (dB) and block-relative max error."""
    x = torch.from_numpy(np.array(sample, np.float32))
    xq = quantize_dequantize(x, spec, axis=-1)
    return {"sqnr_db": float(sqnr_db(x, xq)),
            "max_rel_err": float(max_rel_err_vs_blockmax(x, xq,
                                                         spec.block))}


def sweep_role(stats: CalibStats, role: str,
               cost_fn: Callable[[QuantSpec], float],
               candidates: Sequence[QuantSpec] = DEFAULT_CANDIDATES,
               ) -> Dict[int, List[ScoredSpec]]:
    """Score every candidate on every layer of ``role``: ``{layer:
    [ScoredSpec ...]}`` best quality first, the same candidates in every
    layer, so the search can trade layers against each other under one
    budget."""
    if not candidates:
        raise ValueError("empty candidate search space")
    out: Dict[int, List[ScoredSpec]] = {}
    for layer, ts in sorted(stats.role_layers(role).items()):
        if ts.sample is None or ts.sample.size == 0:
            raise ValueError(
                f"role {role!r} layer {layer}: no sample collected "
                f"(collect_model_stats keeps block samples by default)")
        scored = []
        for spec in candidates:
            q = score_sample(ts.sample, spec)
            scored.append(ScoredSpec(spec=spec, sqnr_db=q["sqnr_db"],
                                     max_rel_err=q["max_rel_err"],
                                     nbytes=float(cost_fn(spec))))
        scored.sort(key=lambda s: s.sqnr_db, reverse=True)
        out[layer] = scored
    return out
