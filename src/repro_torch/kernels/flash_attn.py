"""Forward flash attention as a CUDA kernel.

Port of src/repro/kernels/flash_attn.py::flash_attention (forward).  On
CUDA tensors the wrapper launches a kernel (or raises): bf16, the serving
path's type, runs csrc/flash_attn_tc.cu on the tensor cores (the one new
rounding, P to bf16 before P V, is held to the reference's bf16 tolerance
of 2e-2), f32 runs csrc/flash_attn.cu on the CUDA cores.  Both are built
for head dims 32, 64, 128 and 256; any other head dim up to 256 runs
zero-padded up to the next of those (``kernel_head_dim``), as the
reference's kernel takes any head dim.  On CPU tensors
it computes the plain version, ``ref.flash_attention_ref``.
``flash_attention_vjp`` is the differentiable entry point the model
calls: its forward is ``flash_attention``, its backward recomputes the
plain version densely and differentiates that, as the reference's
``custom_vjp`` does (the backward is no kernel there either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128, 256)   # head dims the kernels are compiled for


def kernel_head_dim(d: int) -> int:
    """The compiled head dim that head dim ``d`` runs at on the card: the
    least of HEAD_DIMS >= d.  The wrapper zero-pads q, k and v up to it,
    which adds nothing to Q K^T, scales the scores by 1/sqrt(d) as
    before, and drops the padded output columns (zero: P times zero V
    columns).  Past 256 no kernel is built: ValueError."""
    for dk in HEAD_DIMS:
        if d <= dk:
            return dk
    raise ValueError(f"flash_attention: head dim {d} is past the largest "
                     f"compiled head dim, {HEAD_DIMS[-1]} (ROADMAP C5)")


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
    dk = kernel_head_dim(d)
    if dk != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d))
                   for t in (q, k, v))
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous "
                         "and 16-byte aligned")
    lib = build.lib()
    launch = lib.flash_attn_tc_launch if q.dtype == torch.bfloat16 \
        else lib.flash_attn_launch
    out = torch.empty_like(q)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, hkv, dk, int(causal), d,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out if dk == d else out[..., :d].contiguous()


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` forward; backward by dense recomputation
    through ``ref.flash_attention_ref`` (the reference's ``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = ref.flash_attention_ref(qr, kr, vr, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (qr, kr, vr), grad)
        return dq, dk, dv, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """``flash_attention`` with a backward (dense recompute); the same
    values and launches forward."""
    return _FlashAttention.apply(q, k, v, causal)
