"""Decoder-only LM, dense GQA family (mirrors
src/repro/models/decoder.py).

The reference stacks layers and drives them with ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts walked by a Python
loop.  Caches and page pools stay layer-stacked on a leading axis (as in
the reference), and each layer reads its slice ``leaf[i]`` — a
contiguous view.  The fused decode window is a Python loop over steps on
the device, with one host transfer of the window's tokens by the caller.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.mx_weight import MXWeight
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

VOCAB_PAD = 512

# matmul weight leaves quantized by ``quantize_weights`` — all (K, N);
# norms, the embedding and the LM head stay fp
_WEIGHT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3"})


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


# =============================================================================
# parameters
# =============================================================================
def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, std^2) in f32 from ``gen``, stored in ``dtype`` (as the
    reference's ``dense_init``/``embed_init``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def _layer_init(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype

    def dense_init(d_in, d_out):
        return _normal(gen, (d_in, d_out), 1.0 / np.sqrt(d_in), dt, device)

    p = {"ln1": torch.ones(d, dtype=dt, device=device),
         "ln2": torch.ones(d, dtype=dt, device=device),
         "attn": {"wq": dense_init(d, nh * hd), "wk": dense_init(d, nkv * hd),
                  "wv": dense_init(d, nkv * hd),
                  "wo": dense_init(nh * hd, d)}}
    if cfg.gated_mlp:
        p["mlp"] = {"w1": dense_init(d, cfg.d_ff),
                    "w3": dense_init(d, cfg.d_ff),
                    "w2": dense_init(cfg.d_ff, d)}
    else:
        p["mlp"] = {"w1": dense_init(d, cfg.d_ff),
                    "w2": dense_init(cfg.d_ff, d)}
    return p


def _quantize_layer_tree(lp, spec):
    """MXWeight-quantize every matmul weight leaf of one layer (None spec
    keeps the layer fp)."""
    if spec is None:
        return lp
    out = {}
    for key, val in lp.items():
        if isinstance(val, dict):
            out[key] = _quantize_layer_tree(val, spec)
        elif key in _WEIGHT_KEYS:
            out[key] = MXWeight.quantize(val, spec)
        else:
            out[key] = val
    return out


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         quantize: bool = False) -> Dict[str, Any]:
    """Random weights on ``device`` from a seeded ``torch.Generator``,
    layer by layer: the embedding at 0.02 std, projections at
    1/sqrt(fan_in) (the reference's ``embed_init``/``dense_init``).  With
    ``quantize`` each layer is converted to weight-resident MXWeight
    storage (``cfg.mx.weights``) as soon as it is made, so the fp weights
    of only one layer exist at a time."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vp, d, dt = padded_vocab(cfg), cfg.d_model, cfg.torch_dtype
    params: Dict[str, Any] = {
        "embed": _normal(gen, (vp, d), 0.02, dt, device), "layers": []}
    for _ in range(cfg.n_layers):
        lp = _layer_init(gen, cfg, device)
        if quantize:
            lp = _quantize_layer_tree(lp, cfg.mx.weights)
        params["layers"].append(lp)
    params["norm_f"] = torch.ones(d, dtype=dt, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, vp), 1.0 / np.sqrt(d), dt,
                                    device)
    return params


def quantize_weights(params, cfg: ModelConfig):
    """Convert every layer's matmul weights to weight-resident MXWeight
    storage per ``cfg.mx.weights``."""
    out = dict(params)
    out["layers"] = [_quantize_layer_tree(lp, cfg.mx.weights)
                     for lp in params["layers"]]
    return out


# =============================================================================
# forward pieces
# =============================================================================
def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)].to(cfg.torch_dtype)


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head; f32 logits (the reference contracts with an
    f32 accumulator and keeps f32 output)."""
    x = L.rms_norm(x, params["norm_f"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return torch.matmul(x.to(torch.float32), head.to(torch.float32))


def _block(lp, x, cfg: ModelConfig, *, positions=None, cache=None,
           cache_pos: int = 0, paged=None):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if paged is not None:
        block_tables, lengths = paged
        a, cache = L.attention_paged_decode(
            lp["attn"], h, cfg, pool=cache, block_tables=block_tables,
            lengths=lengths)
    else:
        a, cache = L.attention(lp["attn"], h, cfg, positions=positions,
                               cache=cache, cache_pos=cache_pos)
    x = x + a
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp"], h2, cfg), cache


def _layer_view(stacked: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in stacked.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Layer-stacked contiguous cache (L, B, max_len, n_kv, X)."""
    return L.init_kv_cache(cfg, batch, max_len, cfg.n_kv_heads, cfg.hd,
                           device, layers_dim=(cfg.n_layers,))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device):
    """Layer-stacked page pools (L, num_pages, page_size, n_kv, X)."""
    return L.init_paged_kv_cache(cfg, num_pages, page_size, cfg.n_kv_heads,
                                 cfg.hd, device, layers_dim=(cfg.n_layers,))


def forward(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full causal forward over tokens (B, S) with no cache; returns
    logits (B, S, Vp) f32."""
    x = _embed(params, cfg, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for lp in params["layers"]:
        x, _ = _block(lp, x, cfg, positions=positions)
    return _head(params, cfg, x)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: int):
    """Process the prompts, fill a contiguous cache at [0, S); returns
    (logits (B, S, Vp) f32, cache, S)."""
    x = _embed(params, cfg, tokens)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, x.device)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(lp, x, cfg, positions=positions,
                      cache=_layer_view(cache, i))
    return _head(params, cfg, x), cache, s


def decode_step(params, token: torch.Tensor, cache, pos: int,
                cfg: ModelConfig):
    """One decode step over the contiguous cache: token (B,) int32 sits at
    position ``pos`` (a host int, the cache length so far) and attends
    positions <= pos.  Returns (logits (B, 1, Vp) f32, cache) — the cache
    is updated in place."""
    x = _embed(params, cfg, token[:, None])
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(lp, x, cfg, positions=positions,
                      cache=_layer_view(cache, i), cache_pos=pos)
    return _head(params, cfg, x), cache


def scatter_prefill(cfg: ModelConfig, pool, cache, page_ids):
    """Scatter a batched contiguous prefill cache into the page pools (in
    place), packing sub-byte codes on the way."""
    return L.paged_cache_scatter(pool, cache, page_ids, cfg)


def paged_decode_step(params, token: torch.Tensor, pool, block_tables,
                      lengths, cfg: ModelConfig):
    """One continuous-batching decode step over the paged KV cache.
    token (B,) int32; block_tables (B, max_pages) int32; lengths (B,)
    int32 (slot b's token sits at position lengths[b]).  Returns (logits
    (B, 1, Vp) f32, pool) — the pool is updated in place."""
    x = _embed(params, cfg, token[:, None])
    paged = (block_tables, lengths)
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(lp, x, cfg, cache=_layer_view(pool, i), paged=paged)
    return _head(params, cfg, x), pool


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling: logits (B, vocab) -> tokens (B,) int32 (the first
    maximal index, as the reference's argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def paged_decode_multi_step(params, token, pool, block_tables, lengths,
                            remaining, cfg: ModelConfig, *, n_steps: int,
                            trash_page: int = 0):
    """``n_steps`` greedy decode steps on the device — the hot loop.

    Tokens, lengths and remaining budgets stay on the device across the
    window.  A slot whose budget is spent is masked: its block-table row
    points at ``trash_page``, its length reads 0 and its token freezes,
    so over-generated steps never touch live pages.  Returns (tokens
    (n_steps, B) int32, pool, lengths, remaining) — the caller moves the
    tokens to the host once per window."""
    vocab = cfg.vocab
    toks: List[torch.Tensor] = []
    for _ in range(n_steps):
        done = remaining <= 0
        bt = torch.where(done[:, None], trash_page, block_tables)
        ln = torch.where(done, 0, lengths)
        logits, pool = paged_decode_step(params, token, pool, bt, ln, cfg)
        nxt = sample_tokens(logits[:, -1, :vocab])
        token = torch.where(done, token, nxt)
        lengths = torch.where(done, lengths, lengths + 1)
        remaining = torch.where(done, remaining, remaining - 1)
        toks.append(token)
    return torch.stack(toks), pool, lengths, remaining

