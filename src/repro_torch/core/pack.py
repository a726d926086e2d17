"""Bit-packed storage for sub-byte MX element codes.

  * E2M1 (4-bit): 2 codes / byte, low nibble first
  * E3M2, E2M3 (6-bit): 4 codes / 3 bytes, little-endian bit order
  * E5M2, E4M3, INT8 (8-bit): identity

``pack_codes``/``unpack_codes`` work along the trailing axis (the KV
pages' head dim); ``pack_codes_rows``/``unpack_codes_rows`` along axis -2
(a weight's contraction axis), so a row slice of packed bytes is the
packed form of the matching block of code rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import MXFormat, get_format


def packed_nbytes(fmt: MXFormat | str, n: int) -> int:
    f = get_format(fmt)
    if f.code_bits <= 4:
        return (n + 1) // 2
    if f.code_bits <= 6:
        return (n + 3) // 4 * 3
    return n


def _pack_last(c: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int32 codes along the trailing axis into uint8 bytes."""
    lead, n = c.shape[:-1], c.shape[-1]
    if bits <= 4:
        assert n % 2 == 0, "4-bit packing needs an even trailing axis"
        pair = c.reshape(lead + (n // 2, 2))
        return (pair[..., 0] | (pair[..., 1] << 4)).to(torch.uint8)
    assert n % 4 == 0, "6-bit packing needs a trailing axis multiple of 4"
    quad = c.reshape(lead + (n // 4, 4))
    w = (quad[..., 0] | (quad[..., 1] << 6) | (quad[..., 2] << 12)
         | (quad[..., 3] << 18))             # 24 bits
    b = torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF], dim=-1)
    return b.reshape(lead + (n // 4 * 3,)).to(torch.uint8)


def _unpack_last(p: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of ``_pack_last``: int32 bytes -> uint8 codes of length n."""
    lead = p.shape[:-1]
    if bits <= 4:
        out = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
        return out.reshape(lead + (n,)).to(torch.uint8)
    trip = p.reshape(lead + (n // 4, 3))
    w = trip[..., 0] | (trip[..., 1] << 8) | (trip[..., 2] << 16)
    c = torch.stack([w & 0x3F, (w >> 6) & 0x3F, (w >> 12) & 0x3F,
                     (w >> 18) & 0x3F], dim=-1)
    return c.reshape(lead + (n,)).to(torch.uint8)


def pack_codes(codes: torch.Tensor, fmt: MXFormat | str) -> torch.Tensor:
    """uint8 codes (values < 2^code_bits) -> packed uint8 stream along the
    trailing axis."""
    f = get_format(fmt)
    if f.code_bits == 8:
        return codes
    return _pack_last(codes.to(torch.int32), f.code_bits)


def unpack_codes(packed: torch.Tensor, fmt: MXFormat | str,
                 n: int) -> torch.Tensor:
    """Packed uint8 stream -> uint8 codes of trailing length ``n``."""
    f = get_format(fmt)
    if f.code_bits == 8:
        return packed
    return _unpack_last(packed.to(torch.int32), f.code_bits, n)


def pack_codes_rows(codes: torch.Tensor,
                    fmt: MXFormat | str) -> torch.Tensor:
    """Pack along axis -2: codes (..., K, N) -> (..., packed_nbytes(K), N)."""
    f = get_format(fmt)
    if f.code_bits == 8:
        return codes
    c = codes.to(torch.int32).transpose(-1, -2)
    return _pack_last(c, f.code_bits).transpose(-1, -2).contiguous()


def unpack_codes_rows(packed: torch.Tensor, fmt: MXFormat | str,
                      k: int) -> torch.Tensor:
    """Inverse of ``pack_codes_rows``: (..., nbytes, N) -> (..., k, N)."""
    f = get_format(fmt)
    if f.code_bits == 8:
        return packed
    p = packed.to(torch.int32).transpose(-1, -2)
    return _unpack_last(p, f.code_bits, k).transpose(-1, -2).contiguous()
