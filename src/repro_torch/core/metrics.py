"""Quantization-quality metrics for MX conversion (mirrors
src/repro/core/metrics.py): f32 reductions, on whatever device the
tensors lie."""
from __future__ import annotations

import torch


def sqnr_db(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB (higher is better)."""
    x = x.to(torch.float32)
    err = x - xq.to(torch.float32)
    ps = torch.mean(x * x)
    pn = torch.mean(err * err) + 1e-30
    return 10.0 * torch.log10(ps / pn)


def max_rel_err_vs_blockmax(x: torch.Tensor, xq: torch.Tensor,
                            block: int = 32) -> torch.Tensor:
    """max |x - xq| / max|block|: the natural error scale of a
    shared-scale format (each element's ulp is set by its block's
    maximum).  A trailing dim shorter than ``block`` is one short block,
    scaled by the full-row max."""
    d = x.shape[-1]
    if d < block:
        block = d
    n = d // block * block
    xb = x[..., :n].reshape(x.shape[:-1] + (-1, block)).to(torch.float32)
    qb = xq[..., :n].reshape(x.shape[:-1] + (-1, block)).to(torch.float32)
    bmax = torch.amax(torch.abs(xb), dim=-1, keepdim=True) + 1e-30
    return torch.amax(torch.abs(xb - qb) / bmax)


def mse(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    d = x.to(torch.float32) - xq.to(torch.float32)
    return torch.mean(d * d)
