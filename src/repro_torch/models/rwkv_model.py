"""RWKV6 decoder-only LM: attention-free, recurrent-state decode
(mirrors src/repro/models/rwkv_model.py).

``params["blocks"]`` is one list of ``n_layers`` blocks (the reference
stacks them for its scan); the state keeps the reference's layer-stacked
layout.  Prefill and decode write the state in place, so a captured
decode step reads and writes the same buffers every replay.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import rwkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (embed, head_logits, normal_init,
                                        padded_vocab, seeded_generator)


def _layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)
            * w.to(torch.float32)).to(x.dtype)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"
         ) -> Dict[str, Any]:
    """Random weights on ``device`` from a seeded ``torch.Generator``, at
    the reference's shapes, dtypes and scales."""
    device = torch.device(device)
    gen = seeded_generator(device, seed)
    d, dt, vp = cfg.d_model, cfg.torch_dtype, padded_vocab(cfg)

    def normal(shape, std, dtype=dt):
        return normal_init(gen, shape, std, dtype, device)

    blocks = []
    for _ in range(cfg.n_layers):
        p = rwkv.rwkv_init(normal, cfg, device)
        p["ln1"] = torch.ones(d, dtype=dt, device=device)
        p["ln2"] = torch.ones(d, dtype=dt, device=device)
        blocks.append(p)
    return {"embed": normal((vp, d), 0.02),
            "ln_in": torch.ones(d, dtype=dt, device=device),
            "blocks": blocks,
            "norm_f": torch.ones(d, dtype=dt, device=device),
            "lm_head": normal((d, vp), 1.0 / np.sqrt(d))}


def _block(lp, x, cfg: ModelConfig, *, state=None, fake_quant=False):
    """One block from a zero state (``state`` None) or from ``state``
    (one block's slices), which receives the new state in place."""
    prev_t = None if state is None else state["tmix_prev"]
    st = None if state is None else state["tmix_state"]
    h = _layer_norm(x, lp["ln1"], cfg.norm_eps)
    a, (last_t, new_st) = rwkv.rwkv_time_mix(lp["tmix"], h, cfg,
                                             prev_token=prev_t, state=st,
                                             fake_quant=fake_quant)
    x = x + a
    prev_c = None if state is None else state["cmix_prev"]
    h = _layer_norm(x, lp["ln2"], cfg.norm_eps)
    c, last_c = rwkv.rwkv_channel_mix(lp["cmix"], h, cfg, prev_token=prev_c,
                                      fake_quant=fake_quant)
    if state is not None:
        state["tmix_state"].copy_(new_st)
        state["tmix_prev"].copy_(last_t)
        state["cmix_prev"].copy_(last_c)
    return x + c


def _run(params, x, cfg: ModelConfig, cache=None, fake_quant=False):
    """The input LayerNorm, then every block: from the state ``cache``
    (written in place) or, for training, from a zero state, each block
    recomputed in the backward pass when ``cfg.remat`` (the reference's
    checkpointed scan step)."""
    x = _layer_norm(x, params["ln_in"], cfg.norm_eps)
    for i, lp in enumerate(params["blocks"]):
        if cache is None:
            x = L.checkpointed(functools.partial(
                _block, lp, cfg=cfg, fake_quant=fake_quant), x, cfg.remat)
        else:
            x = _block(lp, x, cfg, state={n: t[i] for n, t in cache.items()})
    return x


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final LayerNorm, then the LM head (f32 logits)."""
    return head_logits(params, _layer_norm(x, params["norm_f"],
                                           cfg.norm_eps))


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            fake_quant: bool = False):
    """Training forward from a zero state: tokens (B, S) -> (logits (B,
    S, Vp) f32, a zero aux loss)."""
    x = _run(params, embed(params, cfg, tokens), cfg,
             fake_quant=fake_quant)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device="cuda"):
    """The layer-stacked recurrent state; ``max_len`` is unused (the
    state is O(1) in the sequence length)."""
    return rwkv.rwkv_init_state(cfg, batch, device,
                                layers_dim=(cfg.n_layers,))


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: int = 0, cache=None):
    """Process the prompts from a zero state into ``cache`` (zeroed and
    filled in place when given); returns (logits, cache, S)."""
    x = embed(params, cfg, tokens)
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, device=x.device)
    for leaf in cache.values():
        if leaf.shape[1] != b:
            raise ValueError(f"prefill: a state leaf {tuple(leaf.shape)} is "
                             f"not for batch {b}")
        leaf.zero_()
    x = _run(params, x, cfg, cache)
    return _logits(params, cfg, x), cache, s


def decode_step(params, token: torch.Tensor, cache, pos,
                cfg: ModelConfig):
    """One decode step (``pos`` unused: the state carries the position);
    the state is updated in place."""
    x = _run(params, embed(params, cfg, token[:, None]), cfg, cache)
    return _logits(params, cfg, x), cache
