"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention + MLP
block applied before every ``attn_every`` Mamba2 layers (mirrors
src/repro/models/hybrid.py).  The shared block's weights are reused at
every invocation site; each site owns its own KV cache.

``params["blocks"]`` is one list of ``n_layers`` Mamba2 blocks (the
reference stacks them and groups them (G, attn_every) in its scan);
the caches keep the reference's layout: ``attn`` stacked over the G
sites, ``mamba`` over (G, attn_every).  Prefill and decode write every
cache in place, so a captured decode step reads and writes the same
buffers each replay.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (embed, head, normal_init, padded_vocab,
                                        seeded_generator)


def n_groups(cfg: ModelConfig) -> int:
    """Invocation sites of the shared block."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} must divide "
                         f"by attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"
         ) -> Dict[str, Any]:
    """Random weights on ``device`` from a seeded ``torch.Generator``, at
    the reference's shapes, dtypes and scales."""
    device = torch.device(device)
    gen = seeded_generator(device, seed)
    d, dt, vp = cfg.d_model, cfg.torch_dtype, padded_vocab(cfg)
    hd, nh, nkv, ff = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def normal(shape, std, dtype=dt):
        return normal_init(gen, shape, std, dtype, device)

    def dense_init(d_in, d_out):
        return normal((d_in, d_out), 1.0 / np.sqrt(d_in))

    blocks = [ssm.mamba_init(normal, cfg, device)
              for _ in range(cfg.n_layers)]
    mlp = {"w1": dense_init(d, ff)}
    if cfg.gated_mlp:
        mlp["w3"] = dense_init(d, ff)
    mlp["w2"] = dense_init(ff, d)
    shared = {"ln1": torch.ones(d, dtype=dt, device=device),
              "attn": {"wq": dense_init(d, nh * hd),
                       "wk": dense_init(d, nkv * hd),
                       "wv": dense_init(d, nkv * hd),
                       "wo": dense_init(nh * hd, d)},
              "ln2": torch.ones(d, dtype=dt, device=device), "mlp": mlp}
    return {"embed": normal((vp, d), 0.02), "blocks": blocks,
            "shared_attn": shared,
            "norm_f": torch.ones(d, dtype=dt, device=device),
            "lm_head": dense_init(d, vp)}


def _shared_block(sp, x, cfg: ModelConfig, *, positions, cache=None,
                  cache_pos=0, fake_quant: bool = False):
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    a, cache = L.attention(sp["attn"], h, cfg, positions=positions,
                           cache=cache, cache_pos=cache_pos,
                           fake_quant=fake_quant)
    x = x + a
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + L.mlp(sp["mlp"], h, cfg, fake_quant), cache


def _run(params, x, cfg: ModelConfig, *, positions, cache, cache_pos=0,
         decode: bool = False):
    """Prefill or decode through the G groups: the shared block (site g's
    cache), then the group's ``attn_every`` Mamba2 blocks (each its own
    state), every cache written in place."""
    k, sp = cfg.attn_every, params["shared_attn"]
    for g in range(n_groups(cfg)):
        site = {n: t[g] for n, t in cache["attn"].items()}
        x, _ = _shared_block(sp, x, cfg, positions=positions, cache=site,
                             cache_pos=cache_pos)
        for j in range(k):
            lp = params["blocks"][g * k + j]
            st = {n: t[g, j] for n, t in cache["mamba"].items()}
            if decode:
                x, _ = ssm.mamba_decode(lp, x, cfg, st)
            else:
                x, _ = ssm.mamba_block(lp, x, cfg, cache=st)
    return x


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            fake_quant: bool = False):
    """Training forward: tokens (B, S) -> (logits (B, S, Vp) f32, a zero
    aux loss).  With ``cfg.remat`` each group (the shared block and its
    ``attn_every`` Mamba2 blocks, the reference's checkpointed scan step)
    is recomputed in the backward pass.  The shared block's gradient is
    the sum over its sites, accumulated by autograd."""
    x = embed(params, cfg, tokens)
    positions = L.positions(*x.shape[:2], x.device)
    k, sp = cfg.attn_every, params["shared_attn"]
    for g in range(n_groups(cfg)):
        def group(x, g=g):
            x, _ = _shared_block(sp, x, cfg, positions=positions,
                                 fake_quant=fake_quant)
            for lp in params["blocks"][g * k:(g + 1) * k]:
                x, _ = ssm.mamba_block(lp, x, cfg, fake_quant=fake_quant)
            return x

        x = L.checkpointed(group, x, cfg.remat)
    return head(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                               device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Each site's KV cache (G, B, max_len, n_kv, X) and each block's
    Mamba2 state (G, attn_every, ...)."""
    g = n_groups(cfg)
    return {"attn": L.init_kv_cache(cfg, batch, max_len, cfg.n_kv_heads,
                                    cfg.hd, device, layers_dim=(g,)),
            "mamba": ssm.mamba_init_cache(cfg, batch, device,
                                          layers_dim=(g, cfg.attn_every))}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: int, cache=None):
    """Process the prompts, fill the caches (``cache``, when given, is
    zeroed and filled in place); returns (logits, cache, S)."""
    x = embed(params, cfg, tokens)
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, max_len, x.device)
    else:
        for leaf in cache["attn"].values():
            if leaf.shape[1:3] != (b, max_len):
                raise ValueError(f"prefill: a cache leaf {tuple(leaf.shape)}"
                                 f" is not for batch {b} and max_len "
                                 f"{max_len}")
        for leaf in list(cache["attn"].values()) \
                + list(cache["mamba"].values()):
            leaf.zero_()
    x = _run(params, x, cfg, positions=L.positions(b, s, x.device),
             cache=cache)
    return head(params, cfg, x), cache, s


def decode_step(params, token: torch.Tensor, cache, pos,
                cfg: ModelConfig):
    """One decode step at ``pos`` (a host int or a one-element int32
    tensor on the device); every cache is updated in place."""
    x = embed(params, cfg, token[:, None])
    x = _run(params, x, cfg,
             positions=L.positions(x.shape[0], 1, x.device, pos),
             cache=cache, cache_pos=pos, decode=True)
    return head(params, cfg, x), cache
