"""The fused MX KV write as one CUDA kernel (csrc/mx_kv_write.cu).

One launch quantizes k and v along the head dim, bit-packs sub-byte
codes where the role's spec says ``packed`` (page pools only), and
stores codes and E8M0 scales into the page pool (one token per row at
decode, a span per row at the suffix prefill) or the contiguous cache.
It takes the converter's role on the port's serving paths; the
reference writes the cache in plain jnp
(src/repro/models/layers.py::paged_cache_write /
paged_cache_write_tokens / cache_write).  On CUDA tensors each wrapper
launches the kernel (or raises); on CPU tensors it computes the plain
version, ``ref.mx_paged_kv_write_ref`` /
``ref.mx_paged_kv_write_tokens_ref`` / ``ref.mx_cache_kv_write_ref``.
Codes and scales are bit-identical to the plain converter: the kernel
runs its integer sequence.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spec import QuantSpec, as_spec
from repro_torch.kernels import build, ref, tables
from repro_torch.kernels.mx_quant import _format_args

TRASH_PAGE = 0      # where the multi-token mode stores bucket padding
_CODE_LEAVES = {"paged": ("kc_pages", "ks_pages", "vc_pages", "vs_pages"),
                "cache": ("k_codes", "k_scales", "v_codes", "v_scales")}


def _widths(spec: QuantSpec, hd: int, packed: bool):
    """(code-row bytes, scales per row) of one role at head dim ``hd``:
    codes zero-padded to a block multiple, bit-packed where ``packed``."""
    cl = -(-hd // spec.block) * spec.block
    return (spec.storage_nbytes(cl) if packed else cl), cl // spec.block


def _side_args(spec: QuantSpec, kind: int, cb: int):
    """The 13 ints the kernel reads for one role: the format fields, the
    pack kind and the bytes of a code row (kept alive by the caller)."""
    return (ctypes.c_int * 13)(*_format_args(spec), kind, cb)


def _check_kv(name: str, k: torch.Tensor, v: torch.Tensor) -> None:
    if k.dim() != 4 or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"{name}: k and v must both be (B, s, n_kv, hd) of "
                         f"one dtype, got {tuple(k.shape)} {k.dtype} / "
                         f"{tuple(v.shape)} {v.dtype}")


def _check_leaves(name: str, leaves, lead, hd: int, kspec, vspec,
                  packed: bool) -> None:
    """K codes, K scales, V codes, V scales: u8 (*lead, width)."""
    want = _widths(kspec, hd, packed) + _widths(vspec, hd, packed)
    for t, w in zip(leaves, want):
        if t.dtype != torch.uint8 or tuple(t.shape) != tuple(lead) + (w,):
            raise ValueError(f"{name}: a cache leaf is {tuple(t.shape)} "
                             f"{t.dtype}, expected {tuple(lead) + (w,)} "
                             f"uint8")


def _launch(name, k, v, leaves, kspec, vspec, kinds, *, bt=None,
            lengths=None, starts=None, ends=None, max_pages=0, page=0,
            s_max=0, pos=0, pos_dev=None) -> None:
    """Check what the kernel takes and launch it on k's stream.  Paged
    modes pass ``bt`` with ``lengths`` (one token per row) or with
    ``starts`` and ``ends`` (many); the contiguous mode passes none."""
    tables = tuple(t for t in (bt, lengths, starts, ends) if t is not None)
    if k.device.type != "cuda" or any(
            t.device != k.device for t in (v, *leaves, *tables)):
        raise ValueError(f"{name}: all operands must lie on one CUDA "
                         f"device")
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: k and v must be float32 or bfloat16, "
                         f"got {k.dtype}")
    for role, spec in (("key_spec", kspec), ("value_spec", vspec)):
        if spec.block != 32:
            raise ValueError(f"{name}: {role}={spec} has block={spec.block};"
                             f" the kernel takes block=32 (one warp per "
                             f"block)")
    if not all(t.is_contiguous() for t in (k, v, *leaves, *tables)):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.dtype != torch.int32 for t in tables):
        raise ValueError(f"{name}: block_tables and the row positions "
                         f"must be int32")
    b, s, n_kv, hd = k.shape
    fk = _side_args(kspec, kinds[0], leaves[0].shape[-1])
    fv = _side_args(vspec, kinds[1], leaves[2].shape[-1])
    err = build.lib().mx_kv_write_launch(
        k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in leaves),
        *(None if t is None else t.data_ptr()
          for t in (bt, lengths, starts, ends)), TRASH_PAGE,
        None if pos_dev is None else pos_dev.data_ptr(),
        ctypes.addressof(fk), ctypes.addressof(fv),
        int(k.dtype == torch.bfloat16), b, s, n_kv, hd, max_pages, page,
        leaves[0].shape[0], s_max, pos,
        torch.cuda.current_stream(k.device).cuda_stream)
    build.check(err, name)


def mx_paged_kv_write(pool, k: torch.Tensor, v: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      key_spec, value_spec):
    """Write one token per slot into one layer's MX page pool (in place;
    returns the pool).

    pool          kc/vc_pages (n_pages, page, n_kv, CB) u8 with CB =
                  ``spec.storage_nbytes(cl)`` per role (cl: hd rounded up
                  to the block), ks/vs_pages (n_pages, page, n_kv,
                  cl / block) u8
    k, v          (B, 1, n_kv, hd) f32 or bf16
    block_tables  (B, max_pages) int32
    lengths       (B,) int32: slot b's token lands at page
                  block_tables[b, lengths[b] // page], offset
                  lengths[b] % page.  A length past its table, or a
                  table entry naming no page of the pool, is an error
                  on every device: the plain version raises at once,
                  the kernel traps (its launch fails and the next
                  synchronizing call raises)"""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    _check_kv("mx_paged_kv_write", k, v)
    b, s, n_kv, hd = k.shape
    leaves = tuple(pool[n] for n in _CODE_LEAVES["paged"])
    n_pages, page = leaves[0].shape[:2]
    _check_leaves("mx_paged_kv_write", leaves, (n_pages, page, n_kv), hd,
                  key_spec, value_spec, packed=True)
    if s != 1 or block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"mx_paged_kv_write: k/v {tuple(k.shape)} must be "
                         f"(B, 1, n_kv, hd) with block_tables (B, P) and "
                         f"lengths (B,), got {tuple(block_tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    if k.device.type == "cpu":
        return ref.mx_paged_kv_write_ref(pool, k, v, block_tables, lengths,
                                         key_spec, value_spec)
    _launch("mx_paged_kv_write", k, v, leaves, key_spec, value_spec,
            (tables.pack_kind(key_spec), tables.pack_kind(value_spec)),
            bt=block_tables, lengths=lengths,
            max_pages=block_tables.shape[1], page=page)
    mx_paged_kv_write.launches += 1
    return pool


def mx_paged_kv_write_tokens(pool, k: torch.Tensor, v: torch.Tensor,
                             block_tables: torch.Tensor,
                             starts: torch.Tensor, ends: torch.Tensor,
                             key_spec, value_spec):
    """Write a span of tokens per row into one layer's MX page pool (in
    place; returns the pool): the suffix prefill under prefix caching,
    the reference's ``paged_cache_write_tokens``.

    pool          as ``mx_paged_kv_write``'s
    k, v          (G, S, n_kv, hd) f32 or bf16
    block_tables  (G, P) int32, the rows' full tables
    starts, ends  (G,) int32: token t of row g sits at position
                  starts[g] + t; below ends[g] it lands at page
                  block_tables[g, pos // page], offset pos % page, and
                  from ends[g] on (bucket padding) on the trash page 0
                  at the same offset.  A live position past its table, or a
                  table entry naming no page of the pool, is an error on
                  every device: the plain version raises at once, the
                  kernel traps"""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    name = "mx_paged_kv_write_tokens"
    _check_kv(name, k, v)
    g, s, n_kv, hd = k.shape
    leaves = tuple(pool[n] for n in _CODE_LEAVES["paged"])
    n_pages, page = leaves[0].shape[:2]
    _check_leaves(name, leaves, (n_pages, page, n_kv), hd, key_spec,
                  value_spec, packed=True)
    if block_tables.dim() != 2 or block_tables.shape[0] != g \
            or tuple(starts.shape) != (g,) or tuple(ends.shape) != (g,):
        raise ValueError(f"{name}: k/v {tuple(k.shape)} need block_tables "
                         f"(G, P), starts (G,) and ends (G,), got "
                         f"{tuple(block_tables.shape)}, "
                         f"{tuple(starts.shape)} and {tuple(ends.shape)}")
    if k.device.type == "cpu":
        return ref.mx_paged_kv_write_tokens_ref(
            pool, k, v, block_tables, starts, ends, key_spec, value_spec)
    _launch(name, k, v, leaves, key_spec, value_spec,
            (tables.pack_kind(key_spec), tables.pack_kind(value_spec)),
            bt=block_tables, starts=starts, ends=ends,
            max_pages=block_tables.shape[1], page=page)
    mx_paged_kv_write_tokens.launches += 1
    return pool


def mx_cache_kv_write(cache, k: torch.Tensor, v: torch.Tensor, pos,
                      key_spec, value_spec):
    """Write k/v at positions [pos, pos + s) of one layer's contiguous MX
    cache (in place; returns the cache).

    cache         k/v_codes (B, S, n_kv, cl) u8, one code per byte (cl: hd
                  rounded up to the block, padding codes 0), k/v_scales
                  (B, S, n_kv, cl / block) u8
    k, v          (B, s, n_kv, hd) f32 or bf16
    pos           host int, or a one-element int32 tensor on k's device
                  that the kernel reads (the same bytes either way);
                  pos + s <= S.  A position outside the cache is an
                  error on every device: a host int or a CPU tensor
                  raises at once, a CUDA tensor makes the kernel trap
                  (the next synchronizing call raises)"""
    key_spec, value_spec = as_spec(key_spec), as_spec(value_spec)
    _check_kv("mx_cache_kv_write", k, v)
    host_pos, pos_dev = build.position("mx_cache_kv_write", pos, k.device)
    b, s, n_kv, hd = k.shape
    leaves = tuple(cache[n] for n in _CODE_LEAVES["cache"])
    s_max = leaves[0].shape[1]
    _check_leaves("mx_cache_kv_write", leaves, (b, s_max, n_kv), hd,
                  key_spec, value_spec, packed=False)
    if k.device.type == "cpu" and pos_dev is not None:
        host_pos = int(pos_dev)
    if host_pos is not None and (host_pos < 0 or host_pos + s > s_max):
        raise ValueError(f"mx_cache_kv_write: positions [{host_pos}, "
                         f"{host_pos + s}) do not fit a cache of {s_max}")
    if k.device.type == "cpu":
        return ref.mx_cache_kv_write_ref(cache, k, v, host_pos, key_spec,
                                         value_spec)
    _launch("mx_cache_kv_write", k, v, leaves, key_spec, value_spec, (0, 0),
            s_max=s_max, pos=host_pos or 0, pos_dev=pos_dev)
    mx_cache_kv_write.launches += 1
    return cache


mx_paged_kv_write.launches = 0
mx_paged_kv_write_tokens.launches = 0
mx_cache_kv_write.launches = 0
