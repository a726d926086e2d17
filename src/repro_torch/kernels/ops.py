"""Public wrappers over the kernels (mirrors src/repro/kernels/ops.py).

Each wrapper launches its CUDA kernel for a CUDA tensor and computes the
kernel's plain version for a CPU tensor; there is no other switch.

The three ``*_ctx`` wrappers are the reference's sharding-aware entry
points.  Where the reference wraps the kernel in ``shard_map`` over the
installed mesh, each rank of the port already holds local tensors (its q
heads, its slots), so a wrapper calls the kernel on them with the rank's
first q head where its cache holds every KV head (``head0``).  Where the
reference returns None for a layout the kernel does not take, so does
the port, and the caller takes the reference's dense route: that is a
route chosen from the shapes before any launch, the same on every rank,
not a fallback; a launch that fails on a CUDA tensor raises.  A page
pool sharded over the data axes is local to each data rank here, so the
paged kernel reads it where the reference gathers.  In sharded training
(``launch/cells.py``) ``flash_attention_ctx`` runs the flash kernel's
forward on the rank's heads (its backward the dense recompute of
``flash_attention_vjp``), and ``fake_quantize`` the converter on the
rank's gathered weight shard.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.convert import MXArray, mx_dequantize
from repro_torch.core.spec import QuantSpec, as_spec, resolve_spec
from repro_torch.kernels.mx_matmul import mx_matmul_2d
from repro_torch.kernels.mx_quant import mx_quantize_2d

_PAPER_DEFAULT = QuantSpec("e4m3", "paper")


def mx_quantize(x: torch.Tensor, spec=None, mode: Optional[str] = None,
                block: Optional[int] = None, axis: int = -1) -> MXArray:
    """Quantize an ND tensor along ``axis`` with the converter kernel;
    returns an MXArray whose codes are zero-padded to a block multiple
    (the layout of the reference's ``mx_quantize_pallas``).  ``spec`` is
    a QuantSpec or spec string (default ``e4m3@32:paper``), or a bare
    format name with the reference's deprecated ``mode=`` / ``block=``
    keywords."""
    spec = resolve_spec(spec, None, mode, block, default=_PAPER_DEFAULT,
                        caller="mx_quantize")
    axis = axis % x.dim()
    xm = x.to(torch.float32).movedim(axis, -1)
    shape = xm.shape
    n = shape[-1]
    codes, scales = mx_quantize_2d(xm.reshape(-1, n).contiguous(), spec)
    nblk = (n + spec.block - 1) // spec.block
    pad = nblk * spec.block - n
    if pad:
        codes = F.pad(codes, (0, pad))
    codes = codes.reshape(shape[:-1] + (nblk * spec.block,))
    scales = scales.reshape(shape[:-1] + (nblk,))
    return MXArray.from_spec(codes.movedim(-1, axis).contiguous(),
                             scales.movedim(-1, axis).contiguous(), spec,
                             orig_len=n, axis=axis)


def fake_quantize(x: torch.Tensor, spec, axis: int = -1) -> torch.Tensor:
    """QAT fake quantization: x quantized along ``axis`` by the converter
    kernel (one launch of ``mx_quantize_2d`` over x widened to f32, with
    ``axis`` moved last) and dequantized again; returns f32 in x's shape.
    On a CPU tensor the converter is its plain version, so the round trip
    is ``core.convert.quantize_dequantize``'s, and on the card its codes,
    scales and values are those bits too.  x is detached first: as in
    the reference, whose round trip runs on bitcast integers, no gradient
    passes through (ROADMAP C9)."""
    spec = as_spec(spec)
    axis = axis % x.dim()
    xm = x.detach().to(torch.float32).movedim(axis, -1)
    n = xm.shape[-1]
    codes, scales = mx_quantize_2d(xm.reshape(-1, n).contiguous(), spec)
    pad = scales.shape[-1] * spec.block - n
    if pad:
        codes = F.pad(codes, (0, pad))
    lead = xm.shape[:-1]
    mx = MXArray.from_spec(codes.reshape(lead + (codes.shape[-1],)),
                           scales.reshape(lead + (scales.shape[-1],)), spec,
                           orig_len=n, axis=len(lead))
    return mx_dequantize(mx).movedim(-1, axis)


def mx_matmul_resident(a: torch.Tensor, w) -> torch.Tensor:
    """a (..., K) @ dequant(w) for a weight-resident ``MXWeight`` (K, N),
    through the dequant x matmul kernel; returns f32 (..., N).  K is
    zero-padded to the weight's block multiple (the padded code rows
    decode to exact zeros)."""
    from repro_torch.core.mx_weight import MXWeight
    if not isinstance(w, MXWeight) or w.codes.dim() != 2:
        raise TypeError("mx_matmul_resident takes one (K, N) MXWeight")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a2.shape[1] != w.kp:
        a2 = F.pad(a2, (0, w.kp - a2.shape[1]))
    a2 = a2.contiguous()
    if a2.data_ptr() % 16:               # the kernel reads 16-byte words
        a2 = a2.clone()
    out = mx_matmul_2d(a2, w.codes, w.scales, w.spec)
    return out.reshape(lead + (w.n,))


def mx_matmul(a: torch.Tensor, w: MXArray) -> torch.Tensor:
    """a (..., K) @ w through the dequant x matmul kernel, where ``w`` is
    an MXArray of logical shape (K, N) quantized along axis 0 (the
    contraction axis; one code byte per element); returns f32 (..., N).
    K is zero-padded to the codes' block multiple."""
    if w.axis != 0 or w.codes.dim() != 2:
        raise ValueError("mx_matmul: the weight must be a 2-D MXArray "
                         "quantized along the contraction axis (axis 0)")
    k, n = w.shape
    if a.shape[-1] != k:
        raise ValueError(f"mx_matmul: a has K={a.shape[-1]}, the weight "
                         f"{k}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, k)
    kp = w.codes.shape[0]
    if kp != k:
        a2 = F.pad(a2, (0, kp - k))
    out = mx_matmul_2d(a2.contiguous(), w.codes, w.scales, w.spec)
    return out.reshape(lead + (n,))


def flash_attention_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, *, head0: Optional[int] = None,
                        rep: int = 1):
    """Flash attention over the rank's heads (the reference's
    ``flash_attention_ctx``).  q (B, S, Hq, D) holds the rank's q heads;
    with ``head0`` (its first global head) k/v (B, S, Hkv, D) hold every
    KV head, replicated over "model", and q head h reads KV head (head0 +
    h) // rep: the GQA expansion happens on the rank with global head
    offsets, as the reference's does per shard.  Without ``head0`` q's
    heads group over k/v's as one device's do.  Returns None where the
    q heads do not split into KV groups (the caller attends densely)."""
    from repro_torch.kernels.flash_attn import flash_attention_vjp
    if head0 is not None:
        idx = (head0 + torch.arange(q.shape[2], device=q.device)) // rep
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    elif q.shape[2] % k.shape[2]:
        return None
    return flash_attention_vjp(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal)


def mx_decode_attention_ctx(q: torch.Tensor, cache, pos, cfg,
                            head0: Optional[int] = None):
    """MX decode attention over the rank's contiguous cache (the
    reference's ``mx_decode_attention_ctx``): q (B, 1, Hq, D) the rank's
    slots and q heads, ``head0`` its first global head where the cache
    holds every KV head.  Returns (B, 1, Hq, D), or None where the
    kernel does not take the cache layout (the caller dequantizes and
    attends densely)."""
    from repro_torch.kernels.mx_decode_attn import (decode_kernel_takes,
                                                    mx_decode_attention)
    kk, kv = cfg.mx.kv_key, cfg.mx.kv_value
    if not decode_kernel_takes(q.shape[-1], kk, kv,
                               (cache["k_codes"].shape[-1],
                                cache["v_codes"].shape[-1])):
        return None
    return mx_decode_attention(
        q.contiguous(), cache["k_codes"], cache["k_scales"],
        cache["v_codes"], cache["v_scales"], pos, key_spec=kk,
        value_spec=kv, rep=cfg.n_heads // cfg.n_kv_heads, head0=head0)


def mx_paged_decode_attention_ctx(q: torch.Tensor, pool, block_tables,
                                  lengths, cfg,
                                  head0: Optional[int] = None):
    """Paged MX decode attention over the rank's pool (the reference's
    ``mx_paged_decode_attention_ctx``): q (B, 1, Hq, D) the rank's slots
    and q heads, ``head0`` as in ``mx_decode_attention_ctx``.  Returns
    None where the kernel does not take the pool layout (the caller
    gathers the pages and attends densely).  A pool sharded over the data
    axes (``kv_pages``) is no exception: each data rank's pool holds
    every page its slots' block-table rows name, in local ids
    (``serve.paging.BlockManager(partitions=)``), so the kernel reads it
    as it is, where the reference, whose pool is one array split across
    devices, takes its gather route."""
    from repro_torch.kernels.mx_decode_attn import (
        mx_paged_decode_attention, paged_decode_kernel_takes)
    kk, kv = cfg.mx.kv_key, cfg.mx.kv_value
    if not paged_decode_kernel_takes(
            q.shape[-1], kk, kv, (pool["kc_pages"].shape[-1],
                                  pool["vc_pages"].shape[-1]),
            pool["ks_pages"].shape[-1]):
        return None
    return mx_paged_decode_attention(
        q.contiguous(), pool["kc_pages"], pool["ks_pages"],
        pool["vc_pages"], pool["vs_pages"], block_tables, lengths,
        key_spec=kk, value_spec=kv, rep=cfg.n_heads // cfg.n_kv_heads,
        head0=head0)


def quantize_weight(w: torch.Tensor, spec=None, mode: Optional[str] = None,
                    block: Optional[int] = None) -> MXArray:
    """Quantize a (K, N) weight along K (the contraction axis) for
    ``mx_matmul``, with the converter's plain version as the
    reference's does."""
    from repro_torch.core.convert import mx_quantize as mx_quantize_plain
    spec = resolve_spec(spec, None, mode, block, default=_PAPER_DEFAULT,
                        caller="quantize_weight")
    return mx_quantize_plain(w, spec, axis=0)
