"""Forward flash attention as a CUDA kernel.

Port of src/repro/kernels/flash_attn.py::flash_attention (forward).  On
CUDA tensors the wrapper launches a kernel (or raises): bf16, the serving
path's type, runs csrc/flash_attn_tc.cu on the tensor cores (the one new
rounding, P to bf16 before P V, is held to the reference's bf16 tolerance
of 2e-2), f32 runs csrc/flash_attn.cu on the CUDA cores.  On CPU tensors
it computes the plain version, ``ref.flash_attention_ref``.  The
reference's backward is dense recompute, not a kernel; it comes with
training.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128)      # head dims the kernel is compiled for


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over fp q (B, Sq, H, D) and k/v (B, Sk, Hkv, D), H a
    multiple of Hkv (query head h reads KV head h // (H / Hkv)), in f32
    (on the card in bf16, P is rounded to bf16 before P V); causal is
    top-left aligned (col <= row, also when Sq != Sk).
    Returns (B, Sq, H, D) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] or k.shape[1] < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} are not "
                         f"(B, Sq, H, D) and (B, Sk >= 1, Hkv | H, D)")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must lie on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k and v must all be float32 "
                         f"or all bfloat16, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous "
                         "and 16-byte aligned")
    lib = build.lib()
    launch = lib.flash_attn_tc_launch if q.dtype == torch.bfloat16 \
        else lib.flash_attn_launch
    out = torch.empty_like(q)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, hkv, d, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
