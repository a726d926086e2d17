"""Decode tables the CUDA kernels read from device memory.

``decode_elements`` is a function of the code byte alone and
``scale_to_f32`` of the scale byte alone, so a 256-entry f32 table of
each is exact: a kernel that computes ``elem_table[code] *
scale_table[scale]`` produces the reference's dequantized value bit for
bit.  The tables are built once per (format, mode, device) by the plain
functions themselves.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.convert import decode_elements, scale_to_f32
from repro_torch.core.spec import QuantSpec

_CACHE: Dict[Tuple, torch.Tensor] = {}


def elem_table(spec: QuantSpec, device: torch.device) -> torch.Tensor:
    key = ("elem", spec.fmt, spec.mode, str(device))
    if key not in _CACHE:
        codes = torch.arange(256, dtype=torch.int32)
        _CACHE[key] = decode_elements(codes, spec.format, spec.mode) \
            .contiguous().to(device)
    return _CACHE[key]


def scale_table(device: torch.device) -> torch.Tensor:
    key = ("scale", str(device))
    if key not in _CACHE:
        _CACHE[key] = scale_to_f32(torch.arange(256, dtype=torch.int32)) \
            .contiguous().to(device)
    return _CACHE[key]


def pack_kind(spec: QuantSpec) -> int:
    """How codes are stored: 0 one per byte, 1 4-bit packed, 2 6-bit."""
    bits = spec.format.code_bits
    if not spec.packed or bits == 8:
        return 0
    return 1 if bits <= 4 else 2
