"""Layers of the dense GQA decoder (mirrors src/repro/models/layers.py).

Every projection routes through ``dense()``: an ``MXWeight`` operand goes
to the dequant x matmul kernel, an fp weight to ``torch.matmul``.  KV
caches are quantized along the head dim per the ``kv_key``/``kv_value``
policy roles and written, packed, in one launch of the fused KV-write
kernel per layer (a prompt suffix over pages too).  Attention follows
``cfg.attn_impl`` as the reference's does: at ``"flash"`` decode
attention reads the quantized contiguous cache or pages through its
kernels and a causal prompt over fp k/v attends through the flash
kernel; at ``"dense"`` (the default) every attention is plain torch.
Where a decode-attention kernel does not take the layout (the
``*_kernel_takes`` predicates: a head dim that is no multiple of 32,
codes padded past it), attention is dense at ``"flash"`` too, as the
reference's dispatch goes dense there; the choice is made from the
shapes before any launch.  A quantized prefill and the paged suffix
prefill are dense at either value: prefix sharing promises identical
tokens, and both attend the same dequantized bytes.

Unlike the functional reference, cache and page-pool writes update the
given tensors in place (the pools are the largest serving allocation;
copying them per step would double it).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.convert import MXArray, mx_dequantize
from repro_torch.core.mx_weight import MXWeight
from repro_torch.core.pack import pack_codes, unpack_codes
from repro_torch.core.spec import QuantSpec
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.mx_decode_attn import (decode_kernel_takes,
                                                mx_decode_attention,
                                                mx_paged_decode_attention,
                                                paged_decode_kernel_takes)
from repro_torch.kernels.mx_kv_write import (mx_cache_kv_write,
                                             mx_paged_kv_write,
                                             mx_paged_kv_write_tokens)
from repro_torch.kernels.ops import mx_matmul_resident
from repro_torch.kernels.ref import token_pages
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
NEG_INF = -1e30


# =============================================================================
# primitives
# =============================================================================
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.  ``MXWeight``: the weight-resident route through the dequant
    x matmul kernel (f32 accumulate); fp weight: ``torch.matmul`` in the
    activation dtype (f32 accumulate on the card)."""
    if isinstance(w, MXWeight):
        return mx_matmul_resident(x, w).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables (..., dim/2) in f32 for the given positions."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rope_frac: float = 1.0) -> torch.Tensor:
    """Rotate the first ``rope_frac`` of the head dim (chatglm-style 2d
    RoPE rotates half).  x: (B, S, H, D); cos/sin: (B, S, D_r/2)."""
    d = x.shape[-1]
    dr = int(d * rope_frac)
    dr -= dr % 2
    xr, xp = x[..., :dr], x[..., dr:]
    x1, x2 = xr[..., : dr // 2], xr[..., dr // 2:]
    c = cos[..., : dr // 2][:, :, None, :].to(torch.float32)
    s = sin[..., : dr // 2][:, :, None, :].to(torch.float32)
    x1f, x2f = x1.to(torch.float32), x2.to(torch.float32)
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def _sdpa_gqa(q, k, v, mask) -> torch.Tensor:
    """Grouped-query attention without repeating K/V: q (B,Sq,Hq,D), k/v
    (B,Sk,Hkv,D); mask broadcastable to (B, 1, 1, Sq, Sk)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).to(torch.float32)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) \
        * (1.0 / np.sqrt(d))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    # keys no query attends weigh exactly 0; their values are zeroed too,
    # so a non-finite value there (a trash or recycled page's tail)
    # cannot leak in as 0 * NaN
    mask5 = mask.reshape((1,) * (5 - mask.dim()) + tuple(mask.shape))
    seen = mask5.any(dim=-2)                       # (B or 1, 1, 1, Sk)
    v = torch.where(seen.reshape(seen.shape[0], -1, 1, 1), v, 0)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(torch.float32),
                       v.to(torch.float32)).to(q.dtype)
    return out.reshape(b, sq, hq, d)


# =============================================================================
# KV quantization and the contiguous (prefill) cache
# =============================================================================
def _code_len(dim: int, block: int) -> int:
    return -(-dim // block) * block


def _kv_dequant(codes, scales, spec: QuantSpec, dtype,
                orig_len: Optional[int] = None) -> torch.Tensor:
    mx = MXArray.from_spec(codes, scales, spec.replace(packed=False),
                           orig_len=orig_len, axis=codes.dim() - 1)
    return mx_dequantize(mx).to(dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_kv: int,
                  hd: int, device, layers_dim: Tuple[int, ...] = ()):
    """One attention layer's contiguous cache (optionally layer-stacked);
    K and V sized per their policy roles."""
    kk, kv = cfg.mx.kv_key, cfg.mx.kv_value
    if kk is not None:
        def side(spec):
            cl = _code_len(hd, spec.block)
            lead = layers_dim + (batch, max_len, n_kv)
            return (torch.zeros(lead + (cl,), dtype=torch.uint8,
                                device=device),
                    torch.zeros(lead + (cl // spec.block,),
                                dtype=torch.uint8, device=device))

        kc, ks = side(kk)
        vc, vs = side(kv)
        return {"k_codes": kc, "k_scales": ks, "v_codes": vc,
                "v_scales": vs}
    shape = layers_dim + (batch, max_len, n_kv, hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def cache_write(cache, k: torch.Tensor, v: torch.Tensor, pos,
                cfg: ModelConfig):
    """Write k/v (B, s, n_kv, hd) into the cache at position ``pos``
    (in place; returns the cache); an MX cache through the fused KV-write
    kernel.  ``pos`` is a host int or a one-element int32 tensor on k's
    device (the static decode step replayed from a CUDA graph)."""
    s = k.shape[1]
    if cfg.mx.kv_key is not None:
        return mx_cache_kv_write(cache, k.contiguous(), v.contiguous(), pos,
                                 cfg.mx.kv_key, cfg.mx.kv_value)
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1).to(torch.int64) \
            + torch.arange(s, device=k.device)
        cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
        return cache
    cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
    return cache


def cache_read(cache, cfg: ModelConfig, dtype, hd: Optional[int] = None):
    if cfg.mx.kv_key is not None:
        k = _kv_dequant(cache["k_codes"], cache["k_scales"], cfg.mx.kv_key,
                        dtype, hd)
        v = _kv_dequant(cache["v_codes"], cache["v_scales"],
                        cfg.mx.kv_value, dtype, hd)
        return k, v
    return cache["k"].to(dtype), cache["v"].to(dtype)


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    return kpos[None, None, None, None, :] <= qpos[None, None, None, :, None]


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache=None,
              cache_pos=0) -> Tuple[torch.Tensor, Any]:
    """GQA self-attention over x (B, S, d), causal.  With a cache, k/v
    are first written at ``cache_pos`` (a host int, or at decode a
    one-element int32 tensor on x's device).  Decode (S == 1) attends the
    cache's positions <= cache_pos: at ``attn_impl="flash"`` under an MX
    policy through the contiguous MX decode kernel, else densely.  An MX
    prefill attends the *dequantized* cache view densely, as the
    reference's quantized prefill does, so a later suffix prefill over
    shared pages can be bit-identical to it.  A prompt over fresh fp k/v
    (no cache, or an fp cache) attends through the flash kernel at
    ``"flash"``, densely at ``"dense"``."""
    b, s, d = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    mx_kv = cfg.mx.kv_key is not None
    flash = cfg.attn_impl == "flash"
    q = dense(x, p["wq"]).reshape(b, s, nh, hd)
    k = dense(x, p["wk"]).reshape(b, s, nkv, hd)
    v = dense(x, p["wv"]).reshape(b, s, nkv, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin, cfg.rope_frac)
    k = apply_rope(k, cos, sin, cfg.rope_frac)
    mask = None
    if cache is not None:
        cache = cache_write(cache, k, v, cache_pos, cfg)
        if s == 1 and mx_kv and flash and decode_kernel_takes(
                hd, cfg.mx.kv_key, cfg.mx.kv_value,
                (cache["k_codes"].shape[-1], cache["v_codes"].shape[-1])):
            out = mx_decode_attention(
                q.contiguous(), cache["k_codes"], cache["k_scales"],
                cache["v_codes"], cache["v_scales"], cache_pos,
                key_spec=cfg.mx.kv_key, value_spec=cfg.mx.kv_value,
                rep=nh // nkv)
            return dense(out.reshape(b, s, nh * hd), p["wo"]), cache
        if s == 1:
            k, v = cache_read(cache, cfg, x.dtype, hd)
            if isinstance(cache_pos, torch.Tensor):
                cache_pos = cache_pos.reshape(())
            mask = torch.arange(k.shape[1], device=x.device) <= cache_pos
        elif mx_kv:
            kq, vq = cache_read(cache, cfg, x.dtype, hd)
            k, v = kq[:, :s], vq[:, :s]
            mask = _causal_mask(s, s, x.device)
    if mask is None and flash and s > 1:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    else:
        if mask is None:
            mask = _causal_mask(s, k.shape[1], x.device)
        out = _sdpa_gqa(q, k, v, mask)
    out = dense(out.reshape(b, s, nh * hd), p["wo"])
    return out, cache


# =============================================================================
# Paged KV cache (continuous batching)
# =============================================================================
def init_paged_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                        n_kv: int, hd: int, device,
                        layers_dim: Tuple[int, ...] = ()):
    """Page pool of one attention layer (optionally layer-stacked).  Sub-
    byte codes are bit-packed when the role's spec says ``packed``, so an
    E2M1 value pool is half the bytes of an INT8 key pool.  Page 0 is the
    trash page the engine points idle slots at."""
    kk, kv = cfg.mx.kv_key, cfg.mx.kv_value
    if kk is not None:
        def side(spec):
            cl = _code_len(hd, spec.block)
            lead = layers_dim + (num_pages, page_size, n_kv)
            return (torch.zeros(lead + (spec.storage_nbytes(cl),),
                                dtype=torch.uint8, device=device),
                    torch.zeros(lead + (cl // spec.block,),
                                dtype=torch.uint8, device=device))

        kc, ks = side(kk)
        vc, vs = side(kv)
        return {"kc_pages": kc, "ks_pages": ks, "vc_pages": vc,
                "vs_pages": vs}
    shape = layers_dim + (num_pages, page_size, n_kv, hd)
    return {"k_pages": torch.zeros(shape, dtype=cfg.torch_dtype,
                                   device=device),
            "v_pages": torch.zeros(shape, dtype=cfg.torch_dtype,
                                   device=device)}


def paged_page_size(pool) -> int:
    leaf = pool.get("kc_pages", pool.get("k_pages"))
    return leaf.shape[-3]


# pool key -> (contiguous prefill-cache key, element-code policy role)
PAGED_POOL_KEYS = {
    "kc_pages": ("k_codes", "kv_key"), "ks_pages": ("k_scales", None),
    "vc_pages": ("v_codes", "kv_value"), "vs_pages": ("v_scales", None),
    "k_pages": ("k", None), "v_pages": ("v", None),
}


def paged_cache_scatter(pool, cache, page_ids: torch.Tensor,
                        cfg: ModelConfig):
    """Scatter a batched contiguous prefill cache into the page pool (in
    place).  Leaves are layer-stacked: cache (L, G, Lp, n_kv, X), pool
    (L, P, page, n_kv, X); ``page_ids`` (G, npr) names the physical page
    of each (request, logical page), trash-padded past a request's
    allocation.  Sub-byte codes are bit-packed per role on the way."""
    g, npr = page_ids.shape
    flat = page_ids.reshape(-1).to(torch.int64)
    page = paged_page_size(pool)
    for pk, leaf in pool.items():
        ck, role = PAGED_POOL_KEYS[pk]
        val = cache[ck]
        spec = cfg.mx.role(role) if role is not None else None
        if spec is not None and spec.packed:
            val = pack_codes(val, spec.fmt)
        val = val.reshape((val.shape[0], g * npr, page) + val.shape[-2:])
        leaf[:, flat] = val
    return pool


def paged_cache_write(pool, k: torch.Tensor, v: torch.Tensor,
                      pages: torch.Tensor, offsets: torch.Tensor,
                      cfg: ModelConfig):
    """Scatter one token per slot into one layer's page pool (in place).
    k/v (B, 1, n_kv, hd); slot b's token lands at pool[pages[b],
    offsets[b]].  Active slots own distinct pages, so indices collide only
    on the trash page.  Serving writes an MX pool with
    ``mx_paged_kv_write`` straight from the block tables; this, the port
    of the reference's function, hands it each slot's page as a one-page
    table and its offset as the length."""
    kk, kv = cfg.mx.kv_key, cfg.mx.kv_value
    if kk is not None:
        return mx_paged_kv_write(pool, k.contiguous(), v.contiguous(),
                                 pages.to(torch.int32)[:, None],
                                 offsets.to(torch.int32), kk, kv)
    pages, offsets = pages.to(torch.int64), offsets.to(torch.int64)
    pool["k_pages"][pages, offsets] = k[:, 0].to(pool["k_pages"].dtype)
    pool["v_pages"][pages, offsets] = v[:, 0].to(pool["v_pages"].dtype)
    return pool


def paged_cache_write_tokens(pool, k: torch.Tensor, v: torch.Tensor,
                             block_tables: torch.Tensor,
                             starts: torch.Tensor, ends: torch.Tensor,
                             cfg: ModelConfig):
    """Scatter a multi-token span per row into one layer's page pool (in
    place; the suffix prefill under prefix caching).  k/v (G, S, n_kv,
    hd); token t of row g sits at position ``starts[g] + t`` and lands
    through ``block_tables`` (G, P) when that position is below
    ``ends[g]``, else on the trash page 0 at offset (starts[g] + t) %
    page.
    The reference's ``paged_cache_write_tokens`` is handed those pages
    and offsets; here an MX pool's write is one launch of the fused
    KV-write kernel, which finds them itself.  Live positions never
    collide across rows: every page written is private to its slot
    (shared pages were forked first)."""
    kk, kv = cfg.mx.kv_key, cfg.mx.kv_value
    if kk is not None:
        return mx_paged_kv_write_tokens(
            pool, k.contiguous(), v.contiguous(), block_tables, starts,
            ends, kk, kv)
    pages, offsets = token_pages(block_tables, starts, ends, k.shape[1],
                                 paged_page_size(pool))
    pool["k_pages"][pages, offsets] = k.to(pool["k_pages"].dtype)
    pool["v_pages"][pages, offsets] = v.to(pool["v_pages"].dtype)
    return pool


def paged_cache_gather(pool, block_tables: torch.Tensor, cfg: ModelConfig,
                       dtype, hd: int):
    """Gather a slot-major contiguous (B, max_pages*page, n_kv, hd) K/V
    view through the block table, dequantized (the fp-KV decode path)."""
    b = block_tables.shape[0]
    bt = block_tables.to(torch.int64)
    if cfg.mx.kv_key is not None:
        def one(codes_key, scales_key, spec):
            cl = _code_len(hd, spec.block)
            c = pool[codes_key][bt]
            c = c.reshape((b, -1) + c.shape[3:])
            if spec.packed:
                c = unpack_codes(c, spec.fmt, cl)
            s = pool[scales_key][bt]
            s = s.reshape((b, -1) + s.shape[3:])
            return _kv_dequant(c, s, spec, dtype, hd)

        return (one("kc_pages", "ks_pages", cfg.mx.kv_key),
                one("vc_pages", "vs_pages", cfg.mx.kv_value))
    k = pool["k_pages"][bt]
    v = pool["v_pages"][bt]
    return (k.reshape((b, -1) + k.shape[3:]).to(dtype),
            v.reshape((b, -1) + v.shape[3:]).to(dtype))


def attention_paged_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                           pool, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """GQA decode over one layer's paged KV cache: x (B, 1, d); slot b's
    new token sits at position lengths[b] and attends positions <=
    lengths[b].  An MX pool is written by the fused KV-write kernel (it
    finds each slot's page and offset itself) and, at
    ``attn_impl="flash"``, read by the paged attention kernel where that
    takes the layout; an fp pool, ``"dense"``, or a layout the kernel
    does not take is gathered and attended densely."""
    b, s, d = x.shape                          # s == 1
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(x, p["wq"]).reshape(b, s, nh, hd)
    k = dense(x, p["wk"]).reshape(b, s, nkv, hd)
    v = dense(x, p["wv"]).reshape(b, s, nkv, hd)
    cos, sin = rope_tables(lengths[:, None], hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin, cfg.rope_frac)
    k = apply_rope(k, cos, sin, cfg.rope_frac)
    kk, kv = cfg.mx.kv_key, cfg.mx.kv_value
    if kk is not None:
        pool = mx_paged_kv_write(pool, k.contiguous(), v.contiguous(),
                                 block_tables, lengths, kk, kv)
    else:
        page = paged_page_size(pool)
        pages = torch.gather(block_tables, 1,
                             (lengths // page)[:, None].to(torch.int64))[:, 0]
        pool = paged_cache_write(pool, k, v, pages, lengths % page, cfg)
    if kk is not None and cfg.attn_impl == "flash" \
            and paged_decode_kernel_takes(
            hd, kk, kv, (pool["kc_pages"].shape[-1],
                         pool["vc_pages"].shape[-1]),
            pool["ks_pages"].shape[-1]):
        out = mx_paged_decode_attention(
            q.contiguous(), pool["kc_pages"], pool["ks_pages"],
            pool["vc_pages"], pool["vs_pages"], block_tables, lengths,
            key_spec=cfg.mx.kv_key, value_spec=cfg.mx.kv_value,
            rep=nh // nkv)
    else:
        ka, va = paged_cache_gather(pool, block_tables, cfg, x.dtype, hd)
        mask = torch.arange(ka.shape[1], device=x.device)[
            None, None, None, None, :] <= lengths[:, None, None, None, None]
        out = _sdpa_gqa(q, ka, va, mask)
    out = dense(out.reshape(b, s, nh * hd), p["wo"])
    return out, pool


def attention_paged_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                            *, pool, block_tables: torch.Tensor,
                            starts: torch.Tensor, prompt_lens: torch.Tensor
                            ) -> Tuple[torch.Tensor, Any]:
    """GQA prefill of an uncached prompt *suffix* over one layer's paged
    KV cache (prefix sharing): x (G, S, d) holds request g's prompt
    tokens from position ``starts[g]``, padded past ``prompt_lens[g] -
    starts[g]``; ``block_tables`` (G, P) are the slots' full rows, any
    copy-on-write fork already applied.

    The suffix k/v are written into the slot's private pages first (an
    MX pool through the fused KV-write kernel's multi-token mode), then
    every query attends the gathered *dequantized* page view: prefix
    positions from the shared pages, suffix positions from the bytes just
    written.  The contiguous MX prefill attends the same dequantized
    values (``attention``), so prefix-on serving gives the tokens of
    prefix-off.  Dense on purpose at either ``attn_impl``, as in the
    reference: the flash kernel's online softmax is only allclose to
    ``_sdpa_gqa``, and prefix caching promises identical tokens.

    Padded positions write to the trash page and their outputs are
    garbage the engine never reads.  Values past each row's prompt are
    zeroed before attending: a real query weighs them exactly 0, and a
    non-finite byte there (the trash page, or a padded neighbour's NaN)
    cannot leak in as 0 * NaN."""
    g, s, d = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(x, p["wq"]).reshape(g, s, nh, hd)
    k = dense(x, p["wk"]).reshape(g, s, nkv, hd)
    v = dense(x, p["wv"]).reshape(g, s, nkv, hd)
    positions = starts[:, None] + torch.arange(s, device=x.device,
                                               dtype=starts.dtype)[None, :]
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin, cfg.rope_frac)
    k = apply_rope(k, cos, sin, cfg.rope_frac)
    pool = paged_cache_write_tokens(pool, k, v, block_tables, starts,
                                    prompt_lens, cfg)
    ka, va = paged_cache_gather(pool, block_tables, cfg, x.dtype, hd)
    kpos = torch.arange(ka.shape[1], device=x.device)
    live = kpos[None, :] < prompt_lens.to(torch.int64)[:, None]
    va = torch.where(live[:, :, None, None], va, 0)
    mask = kpos[None, None, None, None, :] \
        <= positions.to(torch.int64)[:, None, None, :, None]
    out = _sdpa_gqa(q, ka, va, mask)
    out = dense(out.reshape(g, s, nh * hd), p["wo"])
    return out, pool


# =============================================================================
# MLP
# =============================================================================
def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = dense(x, p["w1"])
    if cfg.gated_mlp:
        g = dense(x, p["w3"])
        h = F.silu(h.to(torch.float32)).to(x.dtype) * g
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(h, p["w2"])
