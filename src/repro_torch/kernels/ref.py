"""Plain PyTorch versions of every kernel (mirrors src/repro/kernels/ref.py).

Each CUDA kernel's wrapper computes these on a CPU tensor, the CPU tests
hold them against the JAX reference, and ``chip_smoke.py`` holds each
kernel against them on the card.  They repeat the kernels' function, not
their arithmetic order, and are no yardstick of speed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.convert import (decode_elements, mx_quantize,
                                      scale_to_f32)
from repro_torch.core.pack import pack_codes, unpack_codes
from repro_torch.core.spec import QuantSpec, as_spec

NEG_INF = -1e30


def mx_quantize_2d_ref(x: torch.Tensor, spec
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Converter: x (M, N) -> codes u8 (M, N), scales u8 (M, ceil(N/32))."""
    spec = as_spec(spec)
    mx = mx_quantize(x.to(torch.float32), spec, axis=-1)
    n = x.shape[-1]
    nblk = (n + spec.block - 1) // spec.block
    return mx.codes[..., :n], mx.scales[..., :nblk]


def kv_quant_ref(x: torch.Tensor, spec: QuantSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k or v (..., hd) along the head dim: codes u8 (..., cl) zero-padded
    to ``cl`` = hd rounded up to the block, scales u8 (..., cl / block)
    (the layout of ``kernels.ops.mx_quantize``)."""
    hd = x.shape[-1]
    codes, scales = mx_quantize_2d_ref(x.reshape(-1, hd), spec)
    nblk = scales.shape[-1]
    pad = nblk * spec.block - hd
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    lead = x.shape[:-1]
    return codes.reshape(lead + (-1,)), scales.reshape(lead + (nblk,))


def mx_cache_kv_write_ref(cache, k: torch.Tensor, v: torch.Tensor, pos: int,
                          key_spec: QuantSpec, value_spec: QuantSpec):
    """Contiguous MX cache write: k/v (B, s, n_kv, hd) quantized along the
    head dim and stored at positions [pos, pos + s) of every row (in
    place).  Codes one per byte."""
    s = k.shape[1]
    kc, ks = kv_quant_ref(k, key_spec)
    vc, vs = kv_quant_ref(v, value_spec)
    for name, val in (("k_codes", kc), ("k_scales", ks),
                      ("v_codes", vc), ("v_scales", vs)):
        cache[name][:, pos:pos + s] = val
    return cache


def mx_paged_kv_write_ref(pool, k: torch.Tensor, v: torch.Tensor,
                          block_tables: torch.Tensor, lengths: torch.Tensor,
                          key_spec: QuantSpec, value_spec: QuantSpec):
    """Paged MX write of one token per slot (in place): k/v (B, 1, n_kv,
    hd); slot b's token lands at page block_tables[b, lengths[b] // page],
    offset lengths[b] % page.  Sub-byte codes are bit-packed per role's
    ``packed``.  Indices collide only on the trash page."""
    page = pool["kc_pages"].shape[-3]
    lengths = lengths.to(torch.int64)
    pages = torch.gather(block_tables.to(torch.int64), 1,
                         (lengths // page)[:, None])[:, 0]
    if bool((pages < 0).any()):        # indexing would wrap, not raise
        raise IndexError("mx_paged_kv_write: a block table names a page "
                         "below 0")
    offsets = lengths % page
    kc, ks = kv_quant_ref(k, key_spec)
    vc, vs = kv_quant_ref(v, value_spec)
    if key_spec.packed:
        kc = pack_codes(kc, key_spec.fmt)
    if value_spec.packed:
        vc = pack_codes(vc, value_spec.fmt)
    for name, val in (("kc_pages", kc), ("ks_pages", ks),
                      ("vc_pages", vc), ("vs_pages", vs)):
        pool[name][pages, offsets] = val[:, 0]
    return pool


def token_pages(block_tables: torch.Tensor, starts: torch.Tensor,
                ends: torch.Tensor, s: int, page: int):
    """Destinations of a multi-token paged write: token t of row g sits at
    position starts[g] + t, which lands at page block_tables[g, pos //
    page] when pos < ends[g] and on the trash page 0 otherwise, offset
    pos % page either way.  Returns (pages, offsets) (G, S) int64.  A live
    position outside its table, or a table entry below 0, raises (the
    kernel traps on the same inputs)."""
    pos = starts.to(torch.int64)[:, None] \
        + torch.arange(s, device=starts.device)[None, :]
    live = pos < ends.to(torch.int64)[:, None]
    idx = pos // page
    n_tab = block_tables.shape[1]
    if bool((live & ((pos < 0) | (idx >= n_tab))).any()):
        raise IndexError("a live position lies outside its block table")
    found = torch.gather(block_tables.to(torch.int64), 1,
                         idx.clamp(0, n_tab - 1))
    pages = torch.where(live, found, 0)
    if bool((pages < 0).any()):        # indexing would wrap, not raise
        raise IndexError("a block table names a page below 0")
    return pages, pos % page


def mx_paged_kv_write_tokens_ref(pool, k: torch.Tensor, v: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 starts: torch.Tensor, ends: torch.Tensor,
                                 key_spec: QuantSpec, value_spec: QuantSpec):
    """Paged MX write of a multi-token span per row (in place): k/v (G, S,
    n_kv, hd); token t of row g lands at position starts[g] + t through
    the block table below ends[g], on the trash page past it
    (``token_pages``).  Sub-byte codes are bit-packed per role's
    ``packed``.  Indices collide only on the trash page."""
    page = pool["kc_pages"].shape[-3]
    pages, offsets = token_pages(block_tables, starts, ends, k.shape[1],
                                 page)
    kc, ks = kv_quant_ref(k, key_spec)
    vc, vs = kv_quant_ref(v, value_spec)
    if key_spec.packed:
        kc = pack_codes(kc, key_spec.fmt)
    if value_spec.packed:
        vc = pack_codes(vc, value_spec.fmt)
    for name, val in (("kc_pages", kc), ("ks_pages", ks),
                      ("vc_pages", vc), ("vs_pages", vs)):
        pool[name][pages, offsets] = val
    return pool


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor,
                spec) -> torch.Tensor:
    """Dequantize (K, N) codes quantized along axis 0 (contraction dim)."""
    spec = as_spec(spec)
    k, n = codes.shape
    elem = decode_elements(codes, spec.format, spec.mode)
    w = elem.reshape(k // spec.block, spec.block, n) \
        * scale_to_f32(scales)[:, None, :]
    return w.reshape(k, n)


def mx_matmul_2d_ref(a: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, spec) -> torch.Tensor:
    """Dequant x matmul: a (M, K) @ dequant(codes (K, N) unpacked) -> f32."""
    w = dequant_ref(codes, scales, spec)
    return torch.matmul(a.to(torch.float32), w)


def _dequant_cache_ref(codes: torch.Tensor, scales: torch.Tensor,
                       spec: QuantSpec) -> torch.Tensor:
    """(B, S, H, D) u8 codes + (B, S, H, D/32) scales -> f32."""
    d = codes.shape[-1]
    elem = decode_elements(codes, spec.format, spec.mode)
    w = elem.reshape(codes.shape[:-1] + (d // 32, 32)) \
        * scale_to_f32(scales)[..., None]
    return w.reshape(codes.shape)


def mx_decode_attention_ref(q, k_codes, k_scales, v_codes, v_scales,
                            lengths, *, key_spec, value_spec,
                            rep: int = 1, head0: int = 0) -> torch.Tensor:
    """Dense masked softmax over a dequantized contiguous cache: slot b
    attends positions <= lengths[b].  q (B, 1, Hq, D) -> same shape; q's
    head h is global head head0 + h and reads KV head (head0 + h) //
    rep."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    k = _dequant_cache_ref(k_codes, k_scales, key_spec)
    v = _dequant_cache_ref(v_codes, v_scales, value_spec)
    s, d = k.shape[1], k.shape[-1]
    idx = (head0 + torch.arange(q.shape[2], device=q.device)) // rep
    ke = k.index_select(2, idx)
    ve = v.index_select(2, idx)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), ke) \
        / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    lengths = lengths.to(torch.int64).reshape(-1)
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        <= lengths[:, None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # positions past a row's length weigh exactly 0; their values are
    # zeroed too, so a non-finite byte there (a recycled or trash page)
    # cannot leak in as 0 * NaN: the kernels never read those positions
    ve = torch.where(mask[:, 0, 0, :, None, None], ve, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, ve)
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale_d: Optional[int] = None) -> torch.Tensor:
    """Dense attention in f32 (the reference's ``flash_attn._dense_ref``):
    q (B, Sq, H, D), k/v (B, Sk, Hkv, D), query head h reads KV head
    h // (H / Hkv); causal is top-left aligned (col <= row, also when
    Sq != Sk); scores scaled by 1/sqrt(scale_d), D by default (the head
    dim before zero padding, as the kernels take it).  Returns (B, Sq, H,
    D) in q's dtype."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).to(torch.float32)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) \
        / torch.sqrt(torch.tensor(float(scale_d or d), dtype=torch.float32))
    if causal:
        mask = torch.arange(sk, device=q.device)[None, :] \
            <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, d).to(q.dtype)


def mx_paged_decode_attention_ref(q, kc_pool, ks_pool, vc_pool, vs_pool,
                                  block_tables, lengths, *, key_spec,
                                  value_spec, rep: int = 1,
                                  head0: int = 0) -> torch.Tensor:
    """Paged decode attention: gather the block-table pages into a
    contiguous layout, unpack the bit-packed codes per role, then run the
    contiguous reference."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    d = ks_pool.shape[-1] * 32
    b, np_max = block_tables.shape
    page, hkv = kc_pool.shape[1], kc_pool.shape[2]
    bt = block_tables.to(torch.int64)

    def gather(pool):
        g = pool[bt]                              # (B, np_max, page, H, X)
        return g.reshape(b, np_max * page, hkv, pool.shape[-1])

    def codes_of(pool, spec):
        g = gather(pool)
        return unpack_codes(g, spec.fmt, d) if spec.packed else g

    return mx_decode_attention_ref(
        q, codes_of(kc_pool, key_spec), gather(ks_pool),
        codes_of(vc_pool, value_spec), gather(vs_pool), lengths,
        key_spec=key_spec, value_spec=value_spec, rep=rep, head0=head0)
