"""The paper's FP32 -> MX converter as a CUDA kernel (csrc/mx_quant.cu).

Port of src/repro/kernels/mx_quant.py::mx_quantize_2d.  On a CUDA tensor
the wrapper launches the kernel (or raises); on a CPU tensor it computes
the plain version, ``ref.mx_quantize_2d_ref``.  The two are bit-identical
by construction: both run the integer sequence of ``core/convert.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.spec import as_spec
from repro_torch.kernels import build, ref


def _format_args(spec):
    f = spec.format
    return (f.mbits, f.bias, int(f.is_int), int(spec.mode == "paper"),
            f.max_exp_paper, f.max_exp_ocp, f.max_mant_at_top_ocp,
            f.nan_mantissa, f.emax_ocp, f.exp_mask, f.sign_shift)


def mx_quantize_2d(x: torch.Tensor, spec
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize x (M, N) along the trailing axis: codes u8 (M, N) and E8M0
    scales u8 (M, ceil(N/32)).  N need not be a multiple of 32."""
    spec = as_spec(spec)
    if x.dim() != 2:
        raise ValueError(f"mx_quantize_2d takes (M, N), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.mx_quantize_2d_ref(x, spec)
    if x.device.type != "cuda":
        raise ValueError(f"mx_quantize_2d: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("mx_quantize_2d: the kernel takes a contiguous "
                         f"float32 tensor, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")
    if spec.block != 32:
        raise ValueError(f"mx_quantize_2d: the kernel supports block=32 "
                         f"(one warp per block), got {spec}")
    m, n = x.shape
    codes = torch.empty((m, n), dtype=torch.uint8, device=x.device)
    scales = torch.empty((m, (n + 31) // 32), dtype=torch.uint8,
                         device=x.device)
    err = build.lib().mx_quant_launch(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), m, n,
        *_format_args(spec), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mx_quantize_2d")
    mx_quantize_2d.launches += 1
    return codes, scales


mx_quantize_2d.launches = 0
