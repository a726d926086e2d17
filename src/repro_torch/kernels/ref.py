"""Plain PyTorch versions of every kernel (mirrors src/repro/kernels/ref.py).

Each CUDA kernel's wrapper computes these on a CPU tensor, the CPU tests
hold them against the JAX reference, and ``chip_smoke.py`` holds each
kernel against them on the card.  They repeat the kernels' function, not
their arithmetic order, and are no yardstick of speed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.convert import (decode_elements, mx_quantize,
                                      scale_to_f32)
from repro_torch.core.pack import unpack_codes
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
                            rep: int = 1) -> torch.Tensor:
    """Dense masked softmax over a dequantized contiguous cache: slot b
    attends positions <= lengths[b].  q (B, 1, Hq, D) -> same shape."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    k = _dequant_cache_ref(k_codes, k_scales, key_spec)
    v = _dequant_cache_ref(v_codes, v_scales, value_spec)
    s, d = k.shape[1], k.shape[-1]
    idx = torch.arange(q.shape[2], device=q.device) // rep
    ke = k.index_select(2, idx)
    ve = v.index_select(2, idx)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), ke) \
        / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    lengths = lengths.to(torch.int64).reshape(-1)
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        <= lengths[:, None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, ve)
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Dense attention in f32 (the reference's ``flash_attn._dense_ref``):
    q (B, Sq, H, D), k/v (B, Sk, Hkv, D), query head h reads KV head
    h // (H / Hkv); causal is top-left aligned (col <= row, also when
    Sq != Sk).  Returns (B, Sq, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).to(torch.float32)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) \
        / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    if causal:
        mask = torch.arange(sk, device=q.device)[None, :] \
            <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, d).to(q.dtype)


def mx_paged_decode_attention_ref(q, kc_pool, ks_pool, vc_pool, vs_pool,
                                  block_tables, lengths, *, key_spec,
                                  value_spec, rep: int = 1) -> torch.Tensor:
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
        key_spec=key_spec, value_spec=value_spec, rep=rep)
