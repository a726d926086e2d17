"""Numeric-health reductions over the paged MX KV pool (mirrors
src/repro/models/health.py).

The converter gives every 32-element block an E8M0 scale byte and
reserves the top encodings for non-finite blocks (SCALE_INF/SCALE_NAN in
paper mode; ocp mode folds both into SCALE_NAN).  Poison detection on a
serving pool is therefore a uint8 compare over the *scale* leaves — a
few bytes per token per layer, no dequantization, no touching the code
pages.  The engine runs :func:`slot_scale_poison` once after each decode
window and after each prefill scatter, and quarantines a flagged slot
before its tokens are emitted.

Scope: MX pools get marker detection; fp pools have no scale bytes, so
they rely on the finite-logits flag the decode window carries
(``decoder.paged_decode_window_step(health=True)``) — a NaN page always
surfaces as non-finite logits for the slot that attends it.

Masking: a slot's block-table row is trash-padded past its allocation,
and recycled pages may hold stale bytes at positions the new owner has
not written yet.  Only positions below the slot's length count.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import poison_threshold
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (group_leaves, kv_groups,
                                       paged_page_size)


def slot_scale_poison(pool, page_tables: torch.Tensor,
                      lengths: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Per-slot MX-block poison flags: (B,) bool, True where a
    SCALE_NAN/SCALE_INF marker byte sits inside the slot's live positions
    (pos < lengths[b]) in any layer's K or V scale pages.

    ``pool``: the page pools, one layer-stacked (L_g, P, page, n_kv, X)
    stack per KV group (``layers.kv_groups``); ``page_tables`` (B, n)
    int32 physical page ids (a block-table slice or a prefill's page
    ids); ``lengths`` (B,) int32 written positions.  The threshold
    follows each group's and role's mode
    (``core.formats.poison_threshold``).  All on the device: nothing
    waits for the host."""
    b, n = page_tables.shape
    page = paged_page_size(pool)
    live = torch.arange(n * page, device=lengths.device)[None, :] \
        < lengths.to(torch.int64)[:, None]
    flags = torch.zeros(b, dtype=torch.bool, device=lengths.device)
    ids = page_tables.to(torch.int64)
    for group in kv_groups(cfg):
        leaves, mx = group_leaves(pool, group), group.cfg.mx
        for key, spec in (("ks_pages", mx.kv_key), ("vs_pages", mx.kv_value)):
            leaf = leaves.get(key)
            if leaf is None or spec is None:   # fp pool: no scale bytes
                continue
            bad = leaf[:, ids] >= poison_threshold(spec.mode)
            bad = bad.any(dim=0).any(dim=-1).any(dim=-1)   # (B, n, page)
            flags |= (bad.reshape(b, n * page) & live).any(dim=-1)
    return flags
