"""MX decode attention as CUDA kernels, over a contiguous cache and over a
page pool.

Ports of src/repro/kernels/mx_decode_attn.py::mx_decode_attention and
::mx_paged_decode_attention.  bf16 q (the serving path) runs the
tensor-core kernels of csrc/mx_decode_attn_tc.cu, which are built for
head dims 32, 64 and 128; f32 q runs the CUDA-core kernels of
csrc/mx_decode_attn.cu and csrc/mx_paged_decode_attn.cu, which take any
multiple of 32.  bf16 q at another multiple of 32 (96, 160, ...) is
routed by its shape to the CUDA-core kernel on an f32 copy of q, and the
output cast back to bf16 (the plain version computes in f32 too).  On
CUDA tensors each wrapper launches its kernel (or raises); on CPU
tensors it computes the plain version,
``ref.mx_decode_attention_ref`` / ``ref.mx_paged_decode_attention_ref``.

``head0`` names q's first head: local head h is global head head0 + h
and reads KV head (head0 + h) // rep, so a rank that holds a slice of
the q heads over every KV head (a sharded mesh whose "model" axis does
not divide the KV heads) attends through the same kernels.  The default,
None, is head 0 of q holding every head (Hq == Hkv x rep, checked); the
kernels then run as they do at head0 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.spec import as_spec
from repro_torch.kernels import build, ref, tables

PAGES_PER_SPLIT = 2     # f32 kernels: pages one block walks; a slot's
#                         pages spread over ceil(max_pages / 2) blocks
TOKENS_PER_SPLIT = 32   # f32 kernel, contiguous cache: positions per block
SPLIT_BLOCKS = 264      # bf16 kernels: blocks to aim for, two per SM of
#                         an H100's 132
TC_HEAD_DIMS = (32, 64, 128)   # head dims of the bf16 kernels
TC_ROWS = 16            # query heads of one bf16 block (one m16 tile)


def decode_kernel_takes(d: int, key_spec, value_spec, code_widths) -> bool:
    """Whether ``mx_decode_attention`` takes this contiguous-cache layout.

    False exactly where the reference's ``mx_decode_attention_ctx``
    returns None on one device (``D % 32``, codes padded past D, a block
    other than 32); the reference then attends densely, and so do the
    layers.  ``code_widths``: the K and V code caches' trailing widths.
    A function of the shapes alone, the same on every device: callers
    choose the dense path from it before any launch."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    return (d % 32 == 0 and key_spec.block == 32 and value_spec.block == 32
            and tuple(code_widths) == (d, d))


def paged_decode_kernel_takes(d: int, key_spec, value_spec, code_widths,
                              scale_width: int) -> bool:
    """Whether ``mx_paged_decode_attention`` takes this page-pool layout.

    False exactly where the reference's ``mx_paged_decode_attention_ctx``
    returns None on one device (``D % 32``, scales for another D, a block
    other than 32, code widths other than ``spec.storage_nbytes(D)``).
    The same on every device."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    return (d % 32 == 0 and scale_width * 32 == d
            and key_spec.block == 32 and value_spec.block == 32
            and tuple(code_widths) == (key_spec.storage_nbytes(d),
                                       value_spec.storage_nbytes(d)))


def split_tokens(span: int, pairs: int) -> int:
    """Positions one block of the bf16 kernels walks: whole passes of its
    4 warps over 16-position tiles (64 positions), as few passes as give
    ``SPLIT_BLOCKS`` blocks over ``pairs`` (row, KV head, m-tile) triples
    and ``span`` positions.  A function of the shapes alone, not of the
    data: at 8 rows x 2 KV heads and 576 positions, 64 (144 blocks)."""
    passes = max(1, -(-span // 64))
    want = max(1, -(-SPLIT_BLOCKS // pairs))
    return 64 * -(-passes // want)


def _require_block32(key_spec, value_spec) -> None:
    for role, spec in (("key_spec", key_spec), ("value_spec", value_spec)):
        if spec.block != 32:
            raise ValueError(
                f"mx_paged_decode_attention: {role}={spec} has block="
                f"{spec.block}; only block=32 scale layouts are supported")


def _check_cuda_operands(name, q, operands, int_operands=()) -> None:
    """The kernels' common contract: one CUDA device, f32/bf16 q, u8
    codes and scales, int32 tables, all contiguous."""
    if q.device.type != "cuda" or any(
            t.device != q.device for t in (*operands, *int_operands)):
        raise ValueError(f"{name}: all operands must lie on one CUDA "
                         f"device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if any(t.dtype != torch.uint8 for t in operands) \
            or any(t.dtype != torch.int32 for t in int_operands):
        raise ValueError(f"{name}: codes and scales must be uint8, "
                         f"tables int32")
    if not all(t.is_contiguous() for t in (q, *operands, *int_operands)):
        raise ValueError(f"{name}: operands must be contiguous")


def _check_tc_operands(name, q, codes) -> None:
    """The bf16 kernels' contract: a head dim they are built for and
    16-byte aligned q and code rows."""
    d = q.shape[-1]
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"{name}: bf16 q needs a head dim in "
                         f"{TC_HEAD_DIMS}, got {d}")
    if any(t.data_ptr() % 16 for t in (q, *codes)):
        raise ValueError(f"{name}: bf16 q and the code caches must be "
                         f"16-byte aligned")


def head_groups(hq: int, rep: int, head0: int):
    """(KV heads read, most q heads of one) by q heads head0 .. head0 +
    hq - 1: the kernels' block groups (every KV head and rep at head0 0
    over all heads)."""
    return (head0 + hq - 1) // rep - head0 // rep + 1, min(rep, hq)


def _check_heads(name, hq, hkv, rep, head0) -> int:
    """``head0`` as an int, checked: None needs every head (Hq == Hkv x
    rep), an int a slice within them."""
    if head0 is None:
        if hq != hkv * rep:
            raise ValueError(f"{name}: Hq={hq} does not match Hkv={hkv} x "
                             f"rep={rep}")
        return 0
    if hq < 1 or rep < 1 or head0 < 0 or head0 + hq > hkv * rep:
        raise ValueError(f"{name}: q heads {head0} .. {head0 + hq - 1} do "
                         f"not lie within Hkv={hkv} x rep={rep}")
    return int(head0)


def _records(b, hq, rep, head0, d, span, dev):
    """(split_tokens, nsplit, record buffer) of a bf16 launch."""
    groups, rmax = head_groups(hq, rep, head0)
    mtiles = -(-rmax // TC_ROWS)
    st = split_tokens(span, b * groups * mtiles)
    nsplit = -(-span // st)
    part = torch.empty((b, groups * mtiles, nsplit, TC_ROWS * (d + 2)),
                       dtype=torch.float32, device=dev)
    return st, nsplit, part


def mx_decode_attention(q, k_codes, k_scales, v_codes, v_scales, pos, *,
                        key_spec, value_spec, rep: int = 1,
                        head0: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a contiguous MX KV cache.

    q             (B, 1, Hq, D) f32 or bf16
    k/v_codes     (B, S, Hkv, D) u8, one code per byte (every format)
    k/v_scales    (B, S, Hkv, D/32) u8 E8M0 scales
    pos           >= 0: every row attends positions <= pos; a host int,
                  or a one-element int32 tensor on q's device that the
                  kernels read (the static decode step replayed from a
                  CUDA graph).  The grid is sized from S either way, so
                  the two give the same bits
    head0         q's first global head (see the module docstring)

    Returns (B, 1, Hq, D) in q's dtype."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    _require_block32(key_spec, value_spec)
    host_pos, pos_dev = build.position("mx_decode_attention", pos, q.device)
    b, s1, hq, d = q.shape
    _, s_len, hkv, _ = k_codes.shape
    if s1 != 1 or d % 32:
        raise ValueError(f"mx_decode_attention: q {tuple(q.shape)} needs "
                         f"one token and D a multiple of 32")
    head0 = _check_heads("mx_decode_attention", hq, hkv, rep, head0)
    cshape, sshape = (b, s_len, hkv, d), (b, s_len, hkv, d // 32)
    if any(tuple(t.shape) != cshape for t in (k_codes, v_codes)) \
            or any(tuple(t.shape) != sshape for t in (k_scales, v_scales)):
        raise ValueError(f"mx_decode_attention: the kernel takes unpadded "
                         f"codes {cshape} and scales {sshape}, got "
                         f"{tuple(k_codes.shape)}/{tuple(v_codes.shape)} "
                         f"and {tuple(k_scales.shape)}/"
                         f"{tuple(v_scales.shape)}")
    if q.device.type == "cpu" and pos_dev is not None:
        host_pos = int(pos_dev)
    if host_pos is not None and host_pos < 0:
        raise ValueError(f"mx_decode_attention: pos must be >= 0, got "
                         f"{host_pos}")
    if q.device.type == "cpu":
        return ref.mx_decode_attention_ref(
            q, k_codes, k_scales, v_codes, v_scales,
            torch.full((b,), host_pos, dtype=torch.int32), key_spec=key_spec,
            value_spec=value_spec, rep=rep, head0=head0)
    if q.dtype == torch.bfloat16 and d not in TC_HEAD_DIMS:
        return mx_decode_attention(
            q.float(), k_codes, k_scales, v_codes, v_scales, pos,
            key_spec=key_spec, value_spec=value_spec,
            rep=rep, head0=head0).to(torch.bfloat16)
    operands = (k_codes, k_scales, v_codes, v_scales)
    _check_cuda_operands("mx_decode_attention", q, operands)
    if k_codes.data_ptr() % 4 or v_codes.data_ptr() % 4:
        raise ValueError("mx_decode_attention: code caches must be "
                         "word-aligned")
    dev = q.device
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(),
            v_codes.data_ptr(), v_scales.data_ptr(),
            None if pos_dev is None else pos_dev.data_ptr(),
            tables.elem_table(key_spec, dev).data_ptr(),
            tables.elem_table(value_spec, dev).data_ptr(),
            tables.scale_table(dev).data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if q.dtype == torch.bfloat16:
        _check_tc_operands("mx_decode_attention", q, (k_codes, v_codes))
        st, nsplit, part = _records(b, hq, rep, head0, d, s_len, dev)
        err = build.lib().mx_decode_attn_tc_launch(
            *ptrs, part.data_ptr(), out.data_ptr(), b, hq, hkv, head0, rep,
            d, s_len, host_pos or 0, st, nsplit, stream)
    else:
        nsplit = -(-s_len // TOKENS_PER_SPLIT)
        groups, rmax = head_groups(hq, rep, head0)
        part = torch.empty((b, groups, nsplit, rmax * (d + 2)),
                           dtype=torch.float32, device=dev)
        err = build.lib().mx_decode_attn_launch(
            *ptrs, part.data_ptr(), out.data_ptr(), b, hq, hkv, head0, rep,
            d, s_len, host_pos or 0, TOKENS_PER_SPLIT, stream)
    build.check(err, "mx_decode_attention")
    mx_decode_attention.launches += 1
    return out


def mx_paged_decode_attention(q, kc_pool, ks_pool, vc_pool, vs_pool,
                              block_tables, lengths, *, key_spec,
                              value_spec, rep: int = 1,
                              head0: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a paged MX KV cache.

    q             (B, 1, Hq, D) f32 or bf16
    kc/vc_pool    (n_pages, page, Hkv, CB) u8; CB per role is
                  ``spec.storage_nbytes(D)`` (bit-packed below 8 bits)
    ks/vs_pool    (n_pages, page, Hkv, D/32) u8 E8M0 scales
    block_tables  (B, max_pages) i32, rows padded with 0 (the trash page)
    lengths       (B,) i32; slot b attends positions <= lengths[b]
    head0         q's first global head (see the module docstring)

    Returns (B, 1, Hq, D) in q's dtype."""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    _require_block32(key_spec, value_spec)
    b, s1, hq, d = q.shape
    n_pages, page, hkv, cb_k = kc_pool.shape
    cb_v = vc_pool.shape[-1]
    if s1 != 1 or d % 32:
        raise ValueError(f"mx_paged_decode_attention: q {tuple(q.shape)} "
                         f"needs one token and D a multiple of 32")
    head0 = _check_heads("mx_paged_decode_attention", hq, hkv, rep, head0)
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
            key_spec=key_spec, value_spec=value_spec, rep=rep, head0=head0)
    if q.dtype == torch.bfloat16 and d not in TC_HEAD_DIMS:
        return mx_paged_decode_attention(
            q.float(), kc_pool, ks_pool, vc_pool, vs_pool, block_tables,
            lengths, key_spec=key_spec, value_spec=value_spec,
            rep=rep, head0=head0).to(torch.bfloat16)
    _check_cuda_operands("mx_paged_decode_attention", q, operands[1:5],
                         operands[5:])
    kkind, vkind = tables.pack_kind(key_spec), tables.pack_kind(value_spec)
    for kind, pool in ((kkind, kc_pool), (vkind, vc_pool)):
        if pool.data_ptr() % (4 if kind == 0 else 2):
            raise ValueError("mx_paged_decode_attention: code pools must "
                             "be word-aligned")
    dev = q.device
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), kc_pool.data_ptr(), ks_pool.data_ptr(),
            vc_pool.data_ptr(), vs_pool.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), tables.elem_table(key_spec, dev).data_ptr(),
            tables.elem_table(value_spec, dev).data_ptr(),
            tables.scale_table(dev).data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if q.dtype == torch.bfloat16:
        _check_tc_operands("mx_paged_decode_attention", q,
                           (kc_pool, vc_pool))
        st, nsplit, part = _records(b, hq, rep, head0, d, max_pages * page,
                                    dev)
        err = build.lib().mx_paged_decode_attn_tc_launch(
            *ptrs, part.data_ptr(), out.data_ptr(), b, hq, hkv, head0, rep,
            d, page, max_pages, cb_k, cb_v, kkind, vkind, st, nsplit, stream)
    else:
        nsplit = -(-max_pages // PAGES_PER_SPLIT)
        groups, rmax = head_groups(hq, rep, head0)
        part = torch.empty((b, groups, nsplit, rmax * (d + 2)),
                           dtype=torch.float32, device=dev)
        err = build.lib().mx_paged_decode_attn_launch(
            *ptrs, part.data_ptr(), out.data_ptr(), b, hq, hkv, head0, rep,
            d, page, max_pages, cb_k, cb_v, kkind, vkind, PAGES_PER_SPLIT,
            stream)
    build.check(err, "mx_paged_decode_attention")
    mx_paged_decode_attention.launches += 1
    by = mx_paged_decode_attention.launches_by_spec
    by[key_spec, value_spec] = by.get((key_spec, value_spec), 0) + 1
    return out


mx_decode_attention.launches = 0
mx_paged_decode_attention.launches = 0
# (key QuantSpec, value QuantSpec) -> launches
mx_paged_decode_attention.launches_by_spec = {}
