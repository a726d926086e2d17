"""Public wrappers over the kernels (mirrors src/repro/kernels/ops.py).

Each wrapper launches its CUDA kernel for a CUDA tensor and computes the
kernel's plain version for a CPU tensor; there is no other switch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.convert import MXArray
from repro_torch.core.spec import as_spec
from repro_torch.kernels.mx_matmul import mx_matmul_2d
from repro_torch.kernels.mx_quant import mx_quantize_2d


def mx_quantize(x: torch.Tensor, spec, axis: int = -1) -> MXArray:
    """Quantize an ND tensor along ``axis`` with the converter kernel;
    returns an MXArray whose codes are zero-padded to a block multiple
    (the layout of the reference's ``mx_quantize_pallas``)."""
    spec = as_spec(spec)
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
