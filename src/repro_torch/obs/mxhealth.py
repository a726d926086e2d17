"""MX quantization-health statistics over the paged KV pool (mirrors
src/repro/obs/mxhealth.py).

The paper's converter gives every 32-element block one E8M0 scale byte
and reserves the top encodings for non-finite blocks (SCALE_INF /
SCALE_NAN — ``core.formats.poison_threshold``).  That byte is the
block's health record: a poisoned block carries a marker at or above the
threshold, a block whose absmax railed the E8M0 range sits exactly at
the largest legal exponent (``threshold - 1``; under a shared scale this
is also the block-level clip indicator), and a denormal-tiny block sits
at encoding 0.  So quantization health over a serving pool is a uint8
classification of the scale leaves — no dequantization, no code pages
touched — masked to the positions each slot wrote (``pos < length``),
as ``models.health.slot_scale_poison`` masks its scan.

:func:`sample_mx_health` is plain torch ops over the layer-stacked pool,
reduced on the device into one small tensor that comes back in one host
transfer per sample (the reference computes the same in jnp, outside
any Pallas kernel).  The engine samples it every ``obs_interval`` sync
windows and publishes the ``mx.*`` gauges.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.formats import poison_threshold
from repro_torch.models.layers import paged_page_size

# per-role stats sample_mx_health returns (and the engine's gauge names
# derive from): total scale bytes in live positions, poison markers,
# blocks at the max legal exponent (the shared-scale clip indicator),
# and blocks at the minimum encoding
scale_stat_names = ("scale_bytes", "poison", "saturated", "underflow")

_ROLES = (("ks_pages", "kv_key"), ("vs_pages", "kv_value"))


def _leaf_stats(leaf, thr: int, ids: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """(4,) int64 stats of one layer-stacked scale leaf (L, P, page, n_kv,
    blocks) over the live positions ``live`` (B, n * page) of the pages
    ``ids`` (B, n)."""
    b = ids.shape[0]
    g = leaf[:, ids]                         # (L, B, n, page, n_kv, blocks)
    per_pos_bytes = g.shape[0] * g.shape[-2] * g.shape[-1]
    preds = torch.stack([g >= thr, g == thr - 1, g == 0])
    per_pos = preds.sum(dim=(1, 5, 6), dtype=torch.int64).reshape(3, b, -1)
    counts = (per_pos * live).sum(dim=(1, 2))
    n_bytes = live.sum(dtype=torch.int64) * per_pos_bytes
    return torch.cat([n_bytes[None], counts])


def sample_mx_health(pool, block_tables: torch.Tensor,
                     lengths: torch.Tensor,
                     cfg) -> Dict[str, Dict[str, int]]:
    """Per-role scale-byte statistics over every slot's live positions.

    ``pool`` is the engine's layer-stacked page pool; ``block_tables``
    (B, n) int32 physical page ids per slot; ``lengths`` (B,) written
    positions.  Returns ``{"kv_key": {stat: int}, "kv_value": {...}}``,
    read back in one host transfer.  A role quantized as fp (no scale
    leaf) reports all-zero stats."""
    dev = block_tables.device
    ids = block_tables.to(torch.int64)
    b, n = ids.shape
    page = paged_page_size(pool)
    live = (torch.arange(n * page, device=dev)[None, :]
            < lengths.to(device=dev, dtype=torch.int64)[:, None])
    rows = []
    for leaf_name, role in _ROLES:
        leaf, spec = pool.get(leaf_name), getattr(cfg.mx, role)
        if leaf is None or spec is None:
            rows.append(torch.zeros(len(scale_stat_names), dtype=torch.int64,
                                    device=dev))
            continue
        rows.append(_leaf_stats(leaf, poison_threshold(spec.mode), ids,
                                live))
    host = torch.stack(rows).tolist()        # the one host transfer
    return {role: dict(zip(scale_stat_names, (int(v) for v in row)))
            for (_, role), row in zip(_ROLES, host)}
