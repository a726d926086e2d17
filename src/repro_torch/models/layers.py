"""Layers of the decoders, dense, MoE and MLA, and the attention the
other families share (mirrors src/repro/models/layers.py).

Every projection routes through ``dense()``: an ``MXWeight`` operand goes
to the dequant x matmul kernel, an fp weight to ``torch.matmul``; an MoE
layer's experts run one such launch per expert (``moe``).  In training
(``fake_quant``, QAT) the policy's ``weights`` and ``activations`` roles
fake-quantize the operands of each projection through the converter
kernel, as the reference's ``dense`` does in plain jnp.  KV
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
tokens, and both attend the same dequantized bytes.  Non-causal
attention (an encoder) and cross-attention over an encoder's k/v are
dense, as the reference's are.  MLA (deepseek-v2) caches the compressed
c_kv and k_rope, each quantized under the ``kv_key`` role by one launch
of the converter kernel, and decodes with W_uk / W_uv absorbed; its
einsums are plain torch, as the reference computes them outside Pallas.

Unlike the functional reference, cache and page-pool writes update the
given tensors in place (the pools are the largest serving allocation;
copying them per step would double it).

Under a mesh (``dist.sharding.set_mesh`` with rules installed) every
rank runs these layers over its local shards, which ``dist.sharding.
shard_params`` placed by the reference's ``param_specs``: a
column-parallel projection (``wq`` ``wk`` ``wv`` ``w1`` ``w3``) gives the
rank's columns with no collective, a row-parallel one (``wo`` ``w2``,
``dense(..., tp="row")``) sums its f32 partials over "model" before the
cast, attention runs on the rank's q heads (``dist.sharding.
head_shard``: its own KV heads where "model" divides them, else every
KV head with the kernels' first-head argument ``head0``; a "model" size
that does not divide the q heads is refused), and an MoE
layer runs the rank's experts and sums the combine over "model".
Without a mesh nothing of this runs: the layers are the one-device
ones.

Under a per-layer ``PolicyTable`` the layers whose KV specs agree form
one group (``kv_groups``): a cache or pool holds one layer-stacked leaf
per name and group, the first group's under the plain names and group
``j``'s as ``<name>.<j>``, and ``kv_layer_view`` hands each layer its
slices.  Every leaf keeps its page (or batch) axis at 1, so the walkers
that copy pages whatever the spec (copy-on-write, swap, snapshots,
scrubbing) take the grouped pool as they take a uniform one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.convert import MXArray, mx_dequantize
from repro_torch.core.mx_weight import MXWeight
from repro_torch.core.pack import pack_codes, unpack_codes
from repro_torch.core.spec import QuantPolicy, QuantSpec
from repro_torch.dist.sharding import (HeadShard, _check_mx_row_gather,
                                       _check_qat_row_shard,
                                       bf16_matmul_out_enabled,
                                       current_mesh, current_rules,
                                       fsdp_gather, head_shard, model_copy,
                                       model_axis_size, model_gather,
                                       model_index, model_parts, model_sum,
                                       use_sharding, weight_gather_enabled,
                                       wgather_parts)
from repro_torch.kernels.mx_kv_write import (mx_cache_kv_write,
                                             mx_paged_kv_write,
                                             mx_paged_kv_write_tokens)
from repro_torch.kernels.ops import (fake_quantize, flash_attention_ctx,
                                     mx_decode_attention_ctx,
                                     mx_matmul_resident,
                                     mx_paged_decode_attention_ctx,
                                     mx_quantize)
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


def checkpointed(fn, x: torch.Tensor, on: bool):
    """``fn(x)``; with ``on`` and gradients enabled under
    ``torch.utils.checkpoint`` (non-reentrant; the reference's
    ``jax.checkpoint`` of a scan step), so that the backward pass
    recomputes ``fn``, kernel launches included, where it needs a tensor
    that ``fn`` saved.  The recompute runs under the rules and mesh
    installed now (a CUDA backward runs on autograd's own thread, which
    sees no thread-local rules): a sharded layer gathers again as its
    forward did."""
    if not (on and torch.is_grad_enabled()):
        return fn(x)
    rules, mesh = current_rules(), current_mesh()

    def run(x):
        with use_sharding(rules, mesh):
            return fn(x)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


def _gather_mx(w, dim: int):
    """An ``MXWeight`` / ``MXArray`` with its codes and scales gathered
    over the ``wgather`` axes on ``dim`` (-2: K rows, -1: N columns):
    the u8 codes move, not dequantized values."""
    codes = fsdp_gather(w.codes, dim)
    scales = fsdp_gather(w.scales, dim)
    if isinstance(w, MXWeight):
        return dataclasses.replace(w, codes=codes, scales=scales,
                                   k=w.k if dim == -1 else
                                   scales.shape[-2] * w.block,
                                   n=codes.shape[-1])
    return dataclasses.replace(w, codes=codes, scales=scales,
                               orig_len=w.orig_len if dim == -1
                               else codes.shape[-2])


def gather_weight(w, tp: str, k: int, n: Optional[int]):
    """The FSDP use-point gather (the reference's ``_gather_spec`` in its
    "col" mode): the weight's "data"-split dim made whole over the
    ``wgather`` axes, its "model"-split dim left split.  ``param_specs``
    puts "data" on K of a column-parallel weight (``k`` its global
    length, the input's width) and on N of a row-parallel one (``n``);
    a dim the placement left whole (``wgather_parts``) is not gathered.
    An MX weight's K is its block-padded length, as the placement's."""
    mxw = isinstance(w, (MXWeight, MXArray))
    if tp == "row":
        if n is None:
            raise ValueError("dense(tp='row') gathers N under the FSDP "
                             "posture: pass the global output width n=")
        dim, size = -1, n
    else:
        dim, size = -2, _code_len(k, w.block) if mxw else k
    if wgather_parts(size) == 1:
        return w
    return _gather_mx(w, dim) if mxw else fsdp_gather(w, w.dim() + dim)


def dense(x: torch.Tensor, w, mx: Optional[QuantPolicy] = None,
          fake_quant: bool = False, tp: str = "col",
          k: Optional[int] = None, n: Optional[int] = None) -> torch.Tensor:
    """x @ w, steered by the policy ``mx``'s ``weights`` / ``activations``
    roles as the reference's ``dense`` is.  ``tp`` is the weight's
    tensor-parallel role (the reference's): "col" shards the output dim
    over "model" (the rank's columns come out, no collective), "row" the
    input dim: where the placement split the global contraction length
    ``k`` over "model" (``model_parts(k) > 1``), x is the rank's chunk,
    and the partial products are summed over "model" before the cast
    (``dist.sharding.model_sum``: sum forward, identity backward), in
    f32, or with ``bf16_matmul_out`` in x's dtype (the reference's
    ``preferred_element_type``).  Under the FSDP posture the weight is
    first gathered over the ``wgather`` axes (``gather_weight``; ``n`` is
    a row-parallel weight's global output width), an MX weight's u8
    codes and scales as they are, after the reference's
    ``_check_mx_row_gather``.  With ``fake_quant`` (QAT) the
    ``activations`` role fake-quantizes x along its last axis and, for an
    fp weight, the ``weights`` role fake-quantizes the (gathered) w
    along axis 0 (K), each through the converter kernel
    (``ops.fake_quantize``; no gradient passes, ROADMAP C9); a
    row-parallel K shard that is no block multiple is refused
    (``_check_qat_row_shard``: its blocks would not be the whole K's).
    ``MXWeight``: the weight-resident route through the dequant x matmul
    kernel (f32 accumulate); ``MXArray`` (quantized along K):
    dequantized, then multiplied; fp weight: ``torch.matmul`` in the
    activation dtype (f32 accumulate on the card)."""
    mxw = isinstance(w, (MXWeight, MXArray))
    if fake_quant and mx is not None and tp == "row" and k is not None \
            and model_parts(k) > 1:
        _check_qat_row_shard(k, x.shape[-1], [
            s.block for s in (mx.activations, None if mxw else mx.weights)
            if s is not None], model_axis_size())
    if fake_quant and mx is not None and mx.activations is not None:
        x = fake_quantize(x, mx.activations, axis=-1).to(x.dtype)
    if weight_gather_enabled():
        if tp == "row" and k is not None and mxw:
            _check_mx_row_gather(_code_len(k, w.block), w.block,
                                 model_axis_size())
        w = gather_weight(w, tp, x.shape[-1], n)
    if tp == "row" and k is not None and model_parts(k) > 1:
        low = bf16_matmul_out_enabled()
        if isinstance(w, MXWeight):
            part = mx_matmul_resident(x, w)
            part = part.to(x.dtype) if low else part
        else:
            if isinstance(w, MXArray):
                w = mx_dequantize(w)
            elif fake_quant and mx is not None and mx.weights is not None:
                w = fake_quantize(w, mx.weights, axis=0)
            part = torch.matmul(x, w.to(x.dtype)) if low else \
                torch.matmul(x.to(torch.float32), w.to(torch.float32))
        return model_sum(part).to(x.dtype)
    if isinstance(w, MXWeight):
        return mx_matmul_resident(x, w).to(x.dtype)
    if isinstance(w, MXArray):
        return torch.matmul(x, mx_dequantize(w).to(x.dtype))
    if fake_quant and mx is not None and mx.weights is not None:
        w = fake_quantize(w, mx.weights, axis=0)
    return torch.matmul(x, w.to(x.dtype))


def positions(b: int, s: int, device, pos=None) -> torch.Tensor:
    """Positions (B, S): 0..S-1 for a prompt, or ``pos`` for one decode
    token, a host int or a one-element int32 tensor on the device (which
    a captured decode step advances on the device)."""
    if pos is None:
        return torch.arange(s, device=device)[None, :].expand(b, s)
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1, 1).expand(b, s)
    return torch.full((b, s), pos, dtype=torch.int32, device=device)


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


def heads(cfg: ModelConfig) -> HeadShard:
    """The rank's attention heads under the installed mesh (every head
    without one)."""
    return head_shard(cfg.n_heads, cfg.n_kv_heads, cfg.hd)


def kv_heads(cfg: ModelConfig) -> int:
    """KV heads a rank's cache or pool holds under the installed mesh."""
    return heads(cfg).n_kv


def _project_q(p, x, cfg, sh: HeadShard, mx, fq) -> torch.Tensor:
    """q of the rank's heads; x is the block's input after ``model_copy``
    (column-parallel)."""
    b, s, _ = x.shape
    q = dense(x, p["wq"], mx, fq)
    return q.reshape(b, s, sh.n_heads, cfg.hd)


def _project_kv(p, x, xc, cfg, sh: HeadShard, mx, fq):
    """k/v of the KV heads the rank's cache holds.  Column-parallel wk /
    wv read ``xc`` (x after ``model_copy``); gathered over "model" where
    their columns split but not by whole KV heads, each rank's q heads
    then reading the whole (backward: the ranks' gradients summed).
    Where wk / wv stay whole on every rank (``head0`` and no gather),
    they read x itself and k/v pass ``model_copy``: each rank's q heads
    read only some KV heads, so their gradients sum over "model"."""
    b, s, _ = x.shape
    whole = sh.head0 is not None and not sh.gather_kv
    src = x if whole else xc
    k = dense(src, p["wk"], mx, fq)
    v = dense(src, p["wv"], mx, fq)
    if sh.gather_kv:
        k, v = model_gather(k, -1, partial=True), \
            model_gather(v, -1, partial=True)
    elif whole:
        k, v = model_copy(k), model_copy(v)
    return (k.reshape(b, s, sh.n_kv, cfg.hd),
            v.reshape(b, s, sh.n_kv, cfg.hd))


def _attend(q, k, v, mask, cfg, sh: HeadShard) -> torch.Tensor:
    """``_sdpa_gqa`` over the rank's heads: with ``sh.head0`` the cache
    holds every KV head and q head h reads KV head (head0 + h) // rep."""
    if sh.head0 is not None:
        rep = cfg.n_heads // cfg.n_kv_heads
        idx = (sh.head0 + torch.arange(q.shape[2], device=q.device)) // rep
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return _sdpa_gqa(q, k, v, mask)


def _out_proj(p, out, cfg, sh: HeadShard, mx, fq) -> torch.Tensor:
    """wo over the attention output (B, S, Hq * hd) of the rank's q
    heads, row-parallel."""
    return dense(out, p["wo"], mx, fq, tp="row", k=cfg.n_heads * cfg.hd,
                 n=cfg.d_model)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, causal: bool = True, cache=None,
              cache_pos=0, tap: Optional[dict] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              fake_quant: bool = False) -> Tuple[torch.Tensor, Any]:
    """GQA attention over x (B, S, d): self-attention, causal unless
    ``causal=False`` (an encoder), or cross-attention over
    ``kv_override`` = (k, v) (B, S_enc, n_kv, hd) from the encoder, which
    takes no RoPE and no cache.  Non-causal attention and
    cross-attention are dense at either ``attn_impl``, as in the
    reference, which sends only causal self-attention to flash.  With a
    cache, k/v are first written at ``cache_pos`` (a host int, or at decode a
    one-element int32 tensor on x's device).  Decode (S == 1) attends the
    cache's positions <= cache_pos: at ``attn_impl="flash"`` under an MX
    policy through the contiguous MX decode kernel, else densely.  An MX
    prefill attends the *dequantized* cache view densely, as the
    reference's quantized prefill does, so a later suffix prefill over
    shared pages can be bit-identical to it.  A prompt over fresh fp k/v
    (no cache, or an fp cache) attends through the flash kernel at
    ``"flash"``, densely at ``"dense"`` (through ``flash_attention_vjp``,
    which a backward pass differentiates).  ``tap`` (calibration) receives
    the post-RoPE, pre-quantization k/v: what the ``kv_key`` /
    ``kv_value`` roles quantize.  ``fake_quant`` (training) goes to each
    projection's ``dense``."""
    b, s, d = x.shape
    hd = cfg.hd
    sh = heads(cfg)
    nh = sh.n_heads
    mx, fq = cfg.mx, fake_quant
    mx_kv = mx.kv_key is not None
    flash = cfg.attn_impl == "flash"
    xc = model_copy(x)
    q = _project_q(p, xc, cfg, sh, mx, fq)
    if kv_override is not None:
        k, v = kv_override
        mask = torch.ones((1, 1, 1, s, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa_gqa(q, k, v, mask)
        return dense(out.reshape(b, s, nh * hd), p["wo"], mx, fq), cache
    k, v = _project_kv(p, x, xc, cfg, sh, mx, fq)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin, cfg.rope_frac)
    k = apply_rope(k, cos, sin, cfg.rope_frac)
    if tap is not None:
        tap["k"], tap["v"] = k, v
    mask = None
    if not causal:
        if cache is not None:
            raise ValueError("attention: a non-causal layer takes no cache")
        mask = torch.ones((1, 1, 1, s, s), dtype=torch.bool,
                          device=x.device)
    if cache is not None:
        cache = cache_write(cache, k, v, cache_pos, cfg)
        out = mx_decode_attention_ctx(q, cache, cache_pos, cfg, sh.head0) \
            if s == 1 and mx_kv and flash else None
        if out is not None:
            return _out_proj(p, out.reshape(b, s, nh * hd), cfg, sh, mx,
                             fq), cache
        if s == 1:
            k, v = cache_read(cache, cfg, x.dtype, hd)
            if isinstance(cache_pos, torch.Tensor):
                cache_pos = cache_pos.reshape(())
            mask = torch.arange(k.shape[1], device=x.device) <= cache_pos
        elif mx_kv:
            kq, vq = cache_read(cache, cfg, x.dtype, hd)
            k, v = kq[:, :s], vq[:, :s]
            mask = _causal_mask(s, s, x.device)
    out = flash_attention_ctx(q, k, v, causal=True, head0=sh.head0,
                              rep=cfg.n_heads // cfg.n_kv_heads) \
        if mask is None and flash and s > 1 else None
    if out is None:
        if mask is None:
            mask = _causal_mask(s, k.shape[1], x.device)
        out = _attend(q, k, v, mask, cfg, sh)
    return _out_proj(p, out.reshape(b, s, nh * hd), cfg, sh, mx, fq), cache


# =============================================================================
# MLA attention (deepseek-v2): compressed KV cache + absorbed decode
# =============================================================================
def _ein(spec: str, *ops, dtype) -> torch.Tensor:
    """An einsum in f32 (the reference's ``preferred_element_type``),
    cast to ``dtype``."""
    return torch.einsum(spec, *(t.to(torch.float32) for t in ops)).to(dtype)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   layers_dim: Tuple[int, ...] = ()):
    """MLA caches the compressed c_kv (``kv_lora``) and the shared k_rope
    (``qk_rope_dim``) per token instead of per-head K/V; under an MX
    policy both follow the ``kv_key`` role (codes zero-padded to a block
    multiple, E8M0 scales)."""
    lead = layers_dim + (batch, max_len)
    spec = cfg.mx.kv_key
    if spec is None:
        dt = cfg.torch_dtype
        return {"ckv": torch.zeros(lead + (cfg.kv_lora,), dtype=dt,
                                   device=device),
                "kr": torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dt,
                                  device=device)}
    out = {}
    for name, dim in (("ckv", cfg.kv_lora), ("kr", cfg.qk_rope_dim)):
        cl = _code_len(dim, spec.block)
        out[name + "_codes"] = torch.zeros(lead + (cl,), dtype=torch.uint8,
                                           device=device)
        out[name + "_scales"] = torch.zeros(lead + (cl // spec.block,),
                                            dtype=torch.uint8, device=device)
    return out


def _q_heads(p, x, cfg: ModelConfig, fake_quant: bool) -> torch.Tensor:
    b, s, _ = x.shape
    mx = cfg.mx
    if cfg.q_lora:
        cq = rms_norm(dense(x, p["w_dq"], mx, fake_quant), p["q_norm"],
                      cfg.norm_eps)
        q = dense(cq, p["w_uq"], mx, fake_quant)
    else:
        q = dense(x, p["w_uq"], mx, fake_quant)
    return q.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)


def _mla_cache_write(cache, ckv: torch.Tensor, kr: torch.Tensor, pos,
                     cfg: ModelConfig):
    """Write ckv (B, s, kv_lora) and kr (B, s, qk_rope_dim) at positions
    [pos, pos + s) of one layer's MLA cache, in place.  Under an MX
    ``kv_key`` each is quantized by one launch of the paper's converter
    kernel (``ops.mx_quantize``; its codes and scales are the plain
    converter's bits).  ``pos`` is a host int or a one-element int32
    tensor on the device (the static decode step)."""
    s = ckv.shape[1]
    spec = cfg.mx.kv_key
    if spec is None:
        vals = {"ckv": ckv, "kr": kr}
    else:
        vals = {}
        for name, t in (("ckv", ckv), ("kr", kr)):
            q = mx_quantize(t, spec, axis=-1)
            vals[name + "_codes"], vals[name + "_scales"] = q.codes, q.scales
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1).to(torch.int64) \
            + torch.arange(s, device=ckv.device)
        for name, val in vals.items():
            cache[name].index_copy_(1, idx, val.to(cache[name].dtype))
    else:
        for name, val in vals.items():
            cache[name][:, pos:pos + s] = val.to(cache[name].dtype)
    return cache


def _mla_cache_read(cache, cfg: ModelConfig, dtype):
    spec = cfg.mx.kv_key
    if spec is None:
        return cache["ckv"].to(dtype), cache["kr"].to(dtype)
    return (_kv_dequant(cache["ckv_codes"], cache["ckv_scales"], spec, dtype,
                        cfg.kv_lora),
            _kv_dequant(cache["kr_codes"], cache["kr_scales"], spec, dtype,
                        cfg.qk_rope_dim))


def mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, cache=None, cache_pos=0,
                  fake_quant: bool = False) -> Tuple[torch.Tensor, Any]:
    """Full (train / prefill) MLA over x (B, S, d), causal: per-head k/v
    materialized from c_kv, scores and values as the reference's f32
    einsums (no kernel: the reference computes MLA outside Pallas).  With
    a cache, the compressed c_kv and k_rope are written at
    ``cache_pos``."""
    b, s, _ = x.shape
    nh, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                      cfg.v_head_dim)
    mx, dt = cfg.mx, x.dtype
    q = _q_heads(p, x, cfg, fake_quant)
    qn, qr = q[..., :dn], q[..., dn:]
    ckv = rms_norm(dense(x, p["w_dkv"], mx, fake_quant), p["kv_norm"],
                   cfg.norm_eps)
    kr = dense(x, p["w_kr"], mx, fake_quant).reshape(b, s, 1, dr)
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    qr = apply_rope(qr, cos, sin)
    kr = apply_rope(kr, cos, sin)
    kn = dense(ckv, p["w_uk"], mx, fake_quant).reshape(b, s, nh, dn)
    v = dense(ckv, p["w_uv"], mx, fake_quant).reshape(b, s, nh, dv)
    scores = (torch.einsum("bqhd,bkhd->bhqk", qn.to(torch.float32),
                           kn.to(torch.float32))
              + torch.einsum("bqhd,bkd->bhqk", qr.to(torch.float32),
                             kr[:, :, 0, :].to(torch.float32))) \
        * (1.0 / np.sqrt(dn + dr))
    scores = torch.where(_causal_mask(s, s, x.device)[0], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = _ein("bhqk,bkhd->bqhd", probs, v, dtype=dt)
    out = dense(out.reshape(b, s, nh * dv), p["wo"], mx, fake_quant)
    if cache is not None:
        cache = _mla_cache_write(cache, ckv, kr[:, :, 0, :], cache_pos, cfg)
    return out, cache


def mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *, cache,
               cache_pos, fake_quant: bool = False
               ) -> Tuple[torch.Tensor, Any]:
    """Absorbed MLA decode of x (B, 1, d) at ``cache_pos`` (a host int or
    a one-element int32 tensor on the device): the new c_kv / k_rope are
    written into the cache first, then scores and outputs are computed
    against the compressed cache directly, W_uk absorbed into q and W_uv
    applied after (per-head K/V of past tokens are never made)."""
    b, s, _ = x.shape                      # s == 1
    nh, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                      cfg.v_head_dim)
    mx, dt = cfg.mx, x.dtype
    q = _q_heads(p, x, cfg, fake_quant)
    qn, qr = q[..., :dn], q[..., dn:]
    ckv_new = rms_norm(dense(x, p["w_dkv"], mx, fake_quant), p["kv_norm"],
                       cfg.norm_eps)
    kr_new = dense(x, p["w_kr"], mx, fake_quant)
    cos, sin = rope_tables(positions(b, s, x.device, cache_pos), dr,
                           cfg.rope_theta)
    qr = apply_rope(qr, cos, sin)
    kr_new = apply_rope(kr_new.reshape(b, s, 1, dr), cos, sin)[:, :, 0, :]
    cache = _mla_cache_write(cache, ckv_new, kr_new, cache_pos, cfg)
    ckv, kr = _mla_cache_read(cache, cfg, dt)       # (B,S,L), (B,S,dr)
    wuk = p["w_uk"].to(dt).reshape(cfg.kv_lora, nh, dn)
    qc = _ein("bqhd,lhd->bqhl", qn, wuk, dtype=dt)
    scores = (torch.einsum("bqhl,bkl->bhqk", qc.to(torch.float32),
                           ckv.to(torch.float32))
              + torch.einsum("bqhd,bkd->bhqk", qr.to(torch.float32),
                             kr.to(torch.float32))) \
        * (1.0 / np.sqrt(dn + dr))
    if isinstance(cache_pos, torch.Tensor):
        cache_pos = cache_pos.reshape(())
    mask = torch.arange(ckv.shape[1], device=x.device) <= cache_pos
    probs = torch.softmax(torch.where(mask, scores, NEG_INF),
                          dim=-1).to(dt)
    ctx = _ein("bhqk,bkl->bqhl", probs, ckv, dtype=dt)
    wuv = p["w_uv"].to(dt).reshape(cfg.kv_lora, nh, dv)
    out = _ein("bqhl,lhd->bqhd", ctx, wuv, dtype=dt)
    out = dense(out.reshape(b, s, nh * dv), p["wo"], mx, fake_quant)
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
    """Positions per page: axis -3 of every pool leaf (P, page, n_kv, X),
    layer-stacked or not."""
    return next(iter(pool.values())).shape[-3]


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
    hd = cfg.hd
    sh = heads(cfg)
    q = _project_q(p, x, cfg, sh, None, False)
    k, v = _project_kv(p, x, x, cfg, sh, None, False)
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
    out = mx_paged_decode_attention_ctx(q, pool, block_tables, lengths, cfg,
                                        sh.head0) \
        if kk is not None and cfg.attn_impl == "flash" else None
    if out is None:
        ka, va = paged_cache_gather(pool, block_tables, cfg, x.dtype, hd)
        mask = torch.arange(ka.shape[1], device=x.device)[
            None, None, None, None, :] <= lengths[:, None, None, None, None]
        out = _attend(q, ka, va, mask, cfg, sh)
    out = _out_proj(p, out.reshape(b, s, sh.n_heads * hd), cfg, sh, None,
                    False)
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
    hd = cfg.hd
    sh = heads(cfg)
    q = _project_q(p, x, cfg, sh, None, False)
    k, v = _project_kv(p, x, x, cfg, sh, None, False)
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
    out = _attend(q, ka, va, mask, cfg, sh)
    out = _out_proj(p, out.reshape(g, s, sh.n_heads * hd), cfg, sh, None,
                    False)
    return out, pool


# =============================================================================
# per-layer KV groups (the caches and pools of a PolicyTable)
# =============================================================================
@dataclasses.dataclass(frozen=True)
class KVGroup:
    """Layers whose (kv_key, kv_value) specs agree, in layer order: their
    cache or pool leaves stack on a leading axis, each named ``<name>`` +
    ``suffix``.  ``cfg`` is the uniform config of the group's first layer
    (every layer of the group has its KV specs)."""
    suffix: str
    layers: Tuple[int, ...]
    cfg: ModelConfig


@functools.lru_cache(maxsize=64)
def kv_groups(cfg: ModelConfig) -> Tuple[KVGroup, ...]:
    """The KV groups of ``cfg``, in order of each group's first layer; a
    uniform policy is one group under the plain leaf names."""
    layers: Dict[Tuple, list] = {}
    for i in range(cfg.n_layers):
        pol = cfg.layer_policy(i)
        layers.setdefault((pol.kv_key, pol.kv_value), []).append(i)
    return tuple(KVGroup("" if j == 0 else f".{j}", tuple(ls),
                         cfg.layer_cfg(ls[0]))
                 for j, ls in enumerate(layers.values()))


@functools.lru_cache(maxsize=64)
def _kv_slots(cfg: ModelConfig) -> Tuple[Tuple[KVGroup, int], ...]:
    slots = {}
    for g in kv_groups(cfg):
        for j, i in enumerate(g.layers):
            slots[i] = (g, j)
    return tuple(slots[i] for i in range(cfg.n_layers))


def leaf_base(name: str) -> str:
    """A grouped leaf's plain name (``"kc_pages.1"`` -> ``"kc_pages"``)."""
    return name.partition(".")[0]


def group_leaves(tree: Dict[str, torch.Tensor],
                 group: KVGroup) -> Dict[str, torch.Tensor]:
    """One group's layer-stacked leaves of a cache or pool, under their
    plain names (the tensors themselves: writes land in ``tree``)."""
    return {leaf_base(k): v for k, v in tree.items()
            if k[len(leaf_base(k)):] == group.suffix}


def kv_layer_view(tree: Dict[str, torch.Tensor], cfg: ModelConfig,
                  i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slices of a grouped cache or pool, under the plain
    names: contiguous views the layer reads and writes in place."""
    group, j = _kv_slots(cfg)[i]
    return {k: v[j] for k, v in group_leaves(tree, group).items()}


def grouped_kv(cfg: ModelConfig, make) -> Dict[str, torch.Tensor]:
    """A cache or pool of every KV group: ``make(group_cfg, layers_dim)``
    builds one group's plain-named leaves, stacked over its layers."""
    out = {}
    for g in kv_groups(cfg):
        for name, leaf in make(g.cfg, (len(g.layers),)).items():
            out[name + g.suffix] = leaf
    return out


def any_mx_kv(cfg: ModelConfig) -> bool:
    """Some layer quantizes its KV cache (the pool has scale bytes)."""
    return any(g.cfg.mx.kv_key is not None for g in kv_groups(cfg))


def any_fp_kv(cfg: ModelConfig) -> bool:
    """Some layer keeps an fp KV cache."""
    return any(g.cfg.mx.kv_key is None for g in kv_groups(cfg))


# =============================================================================
# MLP
# =============================================================================
def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
        fake_quant: bool = False, ff: Optional[int] = None) -> torch.Tensor:
    """The (gated) MLP of hidden width ``ff`` (default ``cfg.d_ff``):
    ``w1`` / ``w3`` column-parallel (x through ``model_copy``), ``w2``
    row-parallel under a mesh."""
    mx = cfg.mx
    xc = model_copy(x)
    h = dense(xc, p["w1"], mx, fake_quant)
    if cfg.gated_mlp:
        g = dense(xc, p["w3"], mx, fake_quant)
        h = F.silu(h.to(torch.float32)).to(x.dtype) * g
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(h, p["w2"], mx, fake_quant, tp="row",
                 k=cfg.d_ff if ff is None else ff, n=x.shape[-1])


# =============================================================================
# MoE: capacity-routed experts (GShard-style groups)
# =============================================================================
GROUP_SIZE = 256   # dispatch group size (the reference's)


def moe_groups(n_tok: int, cfg: ModelConfig) -> Tuple[int, int, int]:
    """(g, gs, cap) of ``n_tok`` tokens: groups of ``gs = min(256,
    n_tok)`` tokens and each expert's capacity ``cap`` per group, as the
    reference computes them.  The reference reshapes the tokens to (g,
    gs, d), which fails when ``n_tok`` is past 256 and no multiple of it
    (ROADMAP C8); so does this, with a ValueError."""
    gs = min(GROUP_SIZE, n_tok)
    g = n_tok // gs
    if g * gs != n_tok:
        raise ValueError(
            f"moe: {n_tok} tokens do not split into groups of {gs}: past "
            f"{GROUP_SIZE} tokens a batch must be a multiple of "
            f"{GROUP_SIZE} (the reference's x.reshape(g, gs, d) fails "
            f"there too; ROADMAP C8)")
    cap = max(1, int(gs * cfg.moe_topk / cfg.n_experts
                     * cfg.capacity_factor))
    return g, gs, cap


def moe_route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """Router probabilities and top-k of grouped tokens xt (g, gs, d):
    logits and softmax in f32, and the top ``k`` experts per token with
    ties to the lower index (as ``lax.top_k``; a stable descending sort,
    with no host sync).  Returns (probs (g, gs, e) f32, topw (g, gs, k)
    renormalised, topi (g, gs, k) int64)."""
    logits = torch.einsum("gsd,de->gse", xt.to(torch.float32),
                          router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)
    return probs, topw, topi


def _expert_mm(t: torch.Tensor, w, mx: Optional[QuantPolicy] = None,
               fake_quant: bool = False) -> torch.Tensor:
    """Per-expert matmuls t (E, R, K) @ w (E, K, N) -> (E, R, N) in t's
    dtype.  An ``MXWeight`` stack: one dequant x matmul launch per expert
    over its rows ``t[i]`` (a contiguous slice) and its weight
    ``w.take(i)`` (views of the stack); an fp stack: one batched matmul
    (f32 accumulate), under ``fake_quant`` over the stack fake-quantized
    along K (axis 1) by the ``weights`` role, as the reference's."""
    if isinstance(w, MXWeight):
        return torch.stack([mx_matmul_resident(t[i], w.take(i))
                            for i in range(t.shape[0])]).to(t.dtype)
    if fake_quant and mx is not None and mx.weights is not None:
        w = fake_quantize(w, mx.weights, axis=1)
    return torch.matmul(t, w.to(t.dtype))


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
        fake_quant: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-factor top-k MoE over x (B, S, d); returns (out, aux) —
    the reference's function (ref layers.py:898-985).

    Tokens are grouped (g, gs); each (token, choice) takes the next slot
    of its expert's capacity buffer in (token, choice) order, and choices
    past ``cap`` are dropped.  Dispatch and combine are one-hot
    contractions, as the reference's (a token's non-finite activation
    reaches its whole group there as here).  The dispatched tokens lie
    expert-major, (E, g * cap, d), so expert i's rows are one contiguous
    slice for its matmuls.  Shared experts run through ``mlp``; ``aux``
    is the Switch load-balance loss.  Under ``fake_quant`` the
    ``activations`` role fake-quantizes the dispatched expert inputs and
    the hidden layer (along their last axis) and the ``weights`` role
    the fp expert stacks.  Nothing here waits for the host, so the layer
    captures into a decode graph."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_topk
    g, gs, cap = moe_groups(b * s, cfg)
    xt = x.reshape(g, gs, d)
    probs, topw, topi = moe_route(p["router"], xt, k)
    experts = torch.arange(e, device=x.device)
    # expert-parallel over "model" (the reference's logical(xe, "batch",
    # "model", None, None)): this rank's experts [e0, e0 + el)
    ep = model_parts(e)
    el = e // ep
    e0 = model_index() * el if ep > 1 else 0
    onehot = (topi[..., None] == experts).to(torch.float32)  # (g,gs,k,e)
    pos_in_e = (torch.cumsum(onehot.reshape(g, gs * k, e), dim=1)
                .reshape(g, gs, k, e) - 1.0) * onehot
    keep = (pos_in_e < cap) & (onehot > 0)
    posq = torch.clamp(pos_in_e, 0, cap - 1).to(torch.int64)
    slots = torch.arange(cap, device=x.device)
    # (g, gs, k, e, cap): each kept (token, choice) hits one (e, slot)
    capoh = ((posq[..., None] == slots) & keep[..., None]).to(x.dtype)
    disp = torch.sum(capoh, dim=2)[:, :, e0:e0 + el]        # (g,gs,el,cap)
    comb = torch.einsum("gsk,gskec->gsec", topw.to(x.dtype),
                        capoh)[:, :, e0:e0 + el]
    xe = torch.einsum("gsec,gsd->egcd", disp, xt).contiguous()
    xe = xe.reshape(el, g * cap, d)
    we, mx = p["experts"], cfg.mx

    def act_q(t):
        if fake_quant and mx.activations is not None:
            return fake_quantize(t, mx.activations, axis=-1).to(t.dtype)
        return t

    xe = act_q(xe)
    h = _expert_mm(xe, we["w1"], mx, fake_quant)
    gte = _expert_mm(xe, we["w3"], mx, fake_quant)
    h = act_q(F.silu(h.to(torch.float32)).to(x.dtype) * gte)
    ye = _expert_mm(h, we["w2"], mx, fake_quant).reshape(el, g, cap, d)
    if ep > 1:
        # the combine sums over every expert: this rank's in f32, then
        # over "model"
        out = model_sum(torch.einsum("gsec,egcd->gsd", comb.float(),
                                     ye.float())).to(x.dtype)
    else:
        out = torch.einsum("gsec,egcd->gsd", comb, ye)
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x, cfg, fake_quant,
                        ff=cfg.moe_d_ff * cfg.n_shared_experts)
    # load-balance aux loss (Switch): e * sum_e f_e * P_e / k
    f_e = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    p_e = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(f_e * p_e) / k
    return out, aux
