"""Decoder-only LM, dense GQA family (mirrors
src/repro/models/decoder.py).

The reference stacks layers and drives them with ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts walked by a Python
loop.  Caches and page pools stay layer-stacked on a leading axis (as in
the reference), and each layer reads its slice ``leaf[i]`` — a
contiguous view.  The fused decode window (the reference's jitted
``lax.scan``) is ``paged_decode_window_step`` repeated: here as a Python
loop (``paged_decode_multi_step``, what a CPU tensor runs), on the card
as one captured CUDA graph replayed once per step
(``repro_torch.serve.graphs``).  Either way sampling keys, lengths,
budgets and the health flag stay on the device, and nothing in a step
waits for the host.
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
    """Final norm + LM head; f32 logits (the reference contracts in the
    activation dtype with an f32 accumulator and keeps f32 output).  A
    bf16 x bf16 head on the card is one bf16-input, f32-output GEMM that
    reads the head's bf16 bytes once; elsewhere both sides widen to f32.
    Products of bf16 values are exact in f32, so the two differ only in
    summation order."""
    x = L.rms_norm(x, params["norm_f"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if x.device.type == "cuda" and x.dtype == head.dtype == torch.bfloat16:
        lead = x.shape[:-1]
        out = torch.mm(x.reshape(-1, x.shape[-1]), head,
                       out_dtype=torch.float32)
        return out.reshape(lead + (head.shape[-1],))
    return torch.matmul(x.to(torch.float32), head.to(torch.float32))


def _block(lp, x, cfg: ModelConfig, *, positions=None, cache=None,
           cache_pos: int = 0, paged=None, paged_prefill=None):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if paged_prefill is not None:
        block_tables, starts, prompt_lens = paged_prefill
        a, cache = L.attention_paged_prefill(
            lp["attn"], h, cfg, pool=cache, block_tables=block_tables,
            starts=starts, prompt_lens=prompt_lens)
    elif paged is not None:
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
            max_len: int, cache=None):
    """Process the prompts, fill a contiguous cache at [0, S); returns
    (logits (B, S, Vp) f32, cache, S).  ``cache`` (``init_cache``'s
    layout for this batch and ``max_len``) is zeroed and filled in place
    instead of a fresh one: a captured decode step keeps reading the same
    buffers."""
    x = _embed(params, cfg, tokens)
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, max_len, x.device)
    else:
        for leaf in cache.values():
            if leaf.shape[1:3] != (b, max_len):
                raise ValueError(f"prefill: a cache leaf {tuple(leaf.shape)}"
                                 f" is not for batch {b} and max_len "
                                 f"{max_len}")
            leaf.zero_()
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(lp, x, cfg, positions=positions,
                      cache=_layer_view(cache, i))
    return _head(params, cfg, x), cache, s


def decode_step(params, token: torch.Tensor, cache, pos,
                cfg: ModelConfig):
    """One decode step over the contiguous cache: token (B,) int32 sits at
    position ``pos`` (the cache length so far) and attends positions <=
    pos.  ``pos`` is a host int or a one-element int32 tensor on the
    device (as the reference's traced scalar), which a captured step
    advances on the device; the two give the same logits bit for bit.
    Returns (logits (B, 1, Vp) f32, cache) — the cache is updated in
    place."""
    x = _embed(params, cfg, token[:, None])
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(1, 1).expand(x.shape[0], 1)
    else:
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


def copy_pool_pages(pool, src: torch.Tensor, dst: torch.Tensor):
    """Copy page contents src[i] -> dst[i] in every layer-stacked pool leaf
    (L, P, page, n_kv, X), in place (the copy-on-write fork under prefix
    sharing).  The bytes copy verbatim whatever the layer's spec, so MX
    and fp pools alike; the leaves stay the tensors a captured decode
    step reads."""
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    for leaf in pool.values():
        leaf.index_copy_(1, dst, leaf.index_select(1, src))
    return pool


def paged_prefill_suffix(params, tokens: torch.Tensor, starts: torch.Tensor,
                         prompt_lens: torch.Tensor, pool,
                         block_tables: torch.Tensor, cfg: ModelConfig):
    """Prefill only the *uncached suffix* of G prompts over the paged KV
    cache (prefix sharing): request g's tokens cover prompt positions
    [starts[g], prompt_lens[g]), padded on the right; earlier positions
    are already in the slot's (shared, read-only) prefix pages.

    tokens (G, S) int32; starts / prompt_lens (G,) int32; block_tables
    (G, max_pages) int32, the slots' full rows with any copy-on-write
    fork applied.  Returns (logits (G, S, Vp) f32, pool), the pool
    written in place; logits row i of request g is prompt position
    starts[g] + i (the engine samples at prompt_lens - starts - 1)."""
    x = _embed(params, cfg, tokens)
    paged_prefill = (block_tables, starts, prompt_lens)
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(lp, x, cfg, cache=_layer_view(pool, i),
                      paged_prefill=paged_prefill)
    return _head(params, cfg, x), pool


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


# =============================================================================
# sampling: counter-based per-slot keys
# =============================================================================
_LANE = 0xFFFFFFFF
# odd multipliers below 2^31: a 32-bit lane times one stays below 2^63, so
# no product overflows int64 on any device
_MUL = (0x7FEB352D, 0x68E31DA5)


def mix32(x):
    """A 32-bit integer hash (the "lowbias32" shift-multiply sequence with
    multipliers below 2^31), on a Python int or an int64 tensor of 32-bit
    lanes; the same bits either way."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _LANE
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _LANE
    return x ^ (x >> 16)


def request_keys(seeds: torch.Tensor) -> torch.Tensor:
    """Sampling keys (G, 2) int64 of G requests from their 32-bit stream
    seeds (``serve.scheduler.request_seed``): [stream, steps so far]."""
    seeds = seeds.to(torch.int64) & _LANE
    return torch.stack([seeds, torch.zeros_like(seeds)], dim=1)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: float):
    """Sample one token per slot on the device.

    logits (B, vocab) f32; keys (B, 2) int64, one counter-based key per
    slot: [stream, steps so far].  The keys advance every call whatever
    the temperature (the reference splits its keys every call), so a
    slot's draws depend only on its stream and its own step count — not
    on the batch, its slot or the decode window — and a window of any
    length gives the per-step loop's tokens.  Greedy (temperature <= 0)
    is the first maximal index, as the reference's argmax.  Otherwise a
    Gumbel-max draw over ``logits / temperature`` in f32: each (slot,
    vocab entry) hashes its stream, step and index into 23 uniform bits,
    u in (0, 1), and adds -log(-log u).  No ``torch.Generator`` is read,
    so the step can be captured in a CUDA graph.  Returns (new keys,
    tokens (B,) int32)."""
    new_keys = torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1)
    if temperature <= 0.0:
        return new_keys, torch.argmax(logits, dim=-1).to(torch.int32)
    sub = mix32(mix32(keys[:, 0]) ^ (keys[:, 1] & _LANE))
    idx = mix32(torch.arange(logits.shape[-1], dtype=torch.int64,
                             device=logits.device))
    bits = mix32(sub[:, None] ^ idx[None, :]) >> 9
    # (k + 1/2) / 2^23 is exact in f32 and lies in [2^-24, 1 - 2^-24]:
    # never 0 or 1, so the Gumbel noise is finite
    u = (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    gumbel = -torch.log(-torch.log(u))
    nxt = torch.argmax(logits.to(torch.float32) / temperature + gumbel,
                       dim=-1)
    return new_keys, nxt.to(torch.int32)


def paged_decode_window_step(params, token, pool, block_tables, lengths,
                             remaining, keys, cfg: ModelConfig, *,
                             temperature: float = 0.0, trash_page: int = 0,
                             health: bool = False):
    """One step of the fused decode window (the body of the reference's
    scan, ``one()``).

    A slot whose budget is spent is masked: its block-table row points at
    ``trash_page``, its length reads 0 and its token, length and budget
    freeze, so over-generated steps never touch live pages.  Returns
    (token, lengths, remaining, keys, bad): ``bad`` (B,) bool flags a slot
    whose logits went non-finite at an active step (None without
    ``health``; the finite-logits half of the numeric-health guard)."""
    done = remaining <= 0
    bt = torch.where(done[:, None], trash_page, block_tables)
    ln = torch.where(done, 0, lengths)
    logits, pool = paged_decode_step(params, token, pool, bt, ln, cfg)
    last = logits[:, -1, :cfg.vocab]
    keys, nxt = sample_tokens(last, keys, temperature)
    bad = (~torch.isfinite(last).all(dim=-1) & ~done) if health else None
    token = torch.where(done, token, nxt)
    lengths = torch.where(done, lengths, lengths + 1)
    remaining = torch.where(done, remaining, remaining - 1)
    return token, lengths, remaining, keys, bad


def paged_decode_multi_step(params, token, pool, block_tables, lengths,
                            remaining, keys, cfg: ModelConfig, *,
                            n_steps: int, temperature: float = 0.0,
                            trash_page: int = 0, health: bool = False):
    """``n_steps`` decode steps on the device — the hot loop, eagerly.

    Tokens, lengths, remaining budgets and sampling keys stay on the
    device across the window (``paged_decode_window_step`` each step);
    the caller moves the tokens to the host once per window.  Returns
    (tokens (n_steps, B) int32, pool, lengths, remaining, keys), plus,
    with ``health``, a (B,) bool flagging slots whose logits went
    non-finite at any active step of the window."""
    toks: List[torch.Tensor] = []
    bad = torch.zeros(token.shape, dtype=torch.bool, device=token.device)
    for _ in range(n_steps):
        token, lengths, remaining, keys, b = paged_decode_window_step(
            params, token, pool, block_tables, lengths, remaining, keys,
            cfg, temperature=temperature, trash_page=trash_page,
            health=health)
        if health:
            bad = bad | b
        toks.append(token)
    out = (torch.stack(toks), pool, lengths, remaining, keys)
    return out + (bad,) if health else out
