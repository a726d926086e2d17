"""Paged MX decode attention as a CUDA kernel
(csrc/mx_paged_decode_attn.cu).

Port of src/repro/kernels/mx_decode_attn.py::mx_paged_decode_attention.
On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it computes the plain version,
``ref.mx_paged_decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.spec import as_spec
from repro_torch.kernels import build, ref, tables

PAGES_PER_SPLIT = 2     # pages one block walks; a slot's pages spread over
#                         ceil(max_pages / 2) blocks per KV head


def _require_block32(key_spec, value_spec) -> None:
    for role, spec in (("key_spec", key_spec), ("value_spec", value_spec)):
        if spec.block != 32:
            raise ValueError(
                f"mx_paged_decode_attention: {role}={spec} has block="
                f"{spec.block}; only block=32 scale layouts are supported")


def mx_paged_decode_attention(q, kc_pool, ks_pool, vc_pool, vs_pool,
                              block_tables, lengths, *, key_spec,
                              value_spec, rep: int = 1) -> torch.Tensor:
    """Decode attention over a paged MX KV cache.

    q             (B, 1, Hq, D) f32 or bf16
    kc/vc_pool    (n_pages, page, Hkv, CB) u8; CB per role is
                  ``spec.storage_nbytes(D)`` (bit-packed below 8 bits)
    ks/vs_pool    (n_pages, page, Hkv, D/32) u8 E8M0 scales
    block_tables  (B, max_pages) i32, rows padded with 0 (the trash page)
    lengths       (B,) i32; slot b attends positions <= lengths[b]

    Returns (B, 1, Hq, D) in q's dtype."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    _require_block32(key_spec, value_spec)
    b, s1, hq, d = q.shape
    n_pages, page, hkv, cb_k = kc_pool.shape
    cb_v = vc_pool.shape[-1]
    if s1 != 1 or hq != hkv * rep or d % 32:
        raise ValueError(f"mx_paged_decode_attention: q {tuple(q.shape)} "
                         f"does not match Hkv={hkv} x rep={rep} with D a "
                         f"multiple of 32")
    if cb_k != key_spec.storage_nbytes(d) \
            or cb_v != value_spec.storage_nbytes(d):
        raise ValueError(f"mx_paged_decode_attention: code widths "
                         f"{cb_k}/{cb_v} do not match {key_spec}/"
                         f"{value_spec} at D={d}")
    if tuple(ks_pool.shape) != (n_pages, page, hkv, d // 32) \
            or tuple(vs_pool.shape) != tuple(ks_pool.shape) \
            or tuple(vc_pool.shape[:3]) != (n_pages, page, hkv):
        raise ValueError("mx_paged_decode_attention: pool shapes disagree")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError("mx_paged_decode_attention: block_tables must be "
                         "(B, max_pages) and lengths (B,)")
    operands = (q, kc_pool, ks_pool, vc_pool, vs_pool, block_tables,
                lengths)
    if q.device.type == "cpu":
        return ref.mx_paged_decode_attention_ref(
            q, kc_pool, ks_pool, vc_pool, vs_pool, block_tables, lengths,
            key_spec=key_spec, value_spec=value_spec, rep=rep)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in operands):
        raise ValueError("mx_paged_decode_attention: all operands must lie "
                         "on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mx_paged_decode_attention: q must be float32 or "
                         f"bfloat16, got {q.dtype}")
    if any(t.dtype != torch.uint8 for t in operands[1:5]) \
            or block_tables.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise ValueError("mx_paged_decode_attention: pools must be uint8, "
                         "block_tables and lengths int32")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("mx_paged_decode_attention: operands must be "
                         "contiguous")
    kkind, vkind = tables.pack_kind(key_spec), tables.pack_kind(value_spec)
    for kind, pool in ((kkind, kc_pool), (vkind, vc_pool)):
        if pool.data_ptr() % (4 if kind == 0 else 2):
            raise ValueError("mx_paged_decode_attention: code pools must "
                             "be word-aligned")
    dev = q.device
    max_pages = block_tables.shape[1]
    nsplit = -(-max_pages // PAGES_PER_SPLIT)
    part = torch.empty((b, hkv, nsplit, rep * (d + 2)), dtype=torch.float32,
                       device=dev)
    out = torch.empty_like(q)
    err = build.lib().mx_paged_decode_attn_launch(
        q.data_ptr(), kc_pool.data_ptr(), ks_pool.data_ptr(),
        vc_pool.data_ptr(), vs_pool.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), tables.elem_table(key_spec, dev).data_ptr(),
        tables.elem_table(value_spec, dev).data_ptr(),
        tables.scale_table(dev).data_ptr(), part.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, page, max_pages, cb_k, cb_v, kkind, vkind,
        int(q.dtype == torch.bfloat16), PAGES_PER_SPLIT,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mx_paged_decode_attention")
    mx_paged_decode_attention.launches += 1
    return out


mx_paged_decode_attention.launches = 0
