"""Dequant x matmul with MX weights as CUDA kernels.

Port of src/repro/kernels/mx_matmul.py::mx_matmul_2d.  Each activation
dtype has one kernel: bf16 (the serving path) runs the tensor-core kernel
of csrc/mx_matmul_tc.cu, f32 the CUDA-core kernel of csrc/mx_matmul.cu.
On a CUDA tensor the wrapper launches that kernel (or raises); on a CPU
tensor it computes the plain version, ``ref.mx_matmul_2d_ref``, after
undoing the packing.
"""
from __future__ import annotations

import torch

from repro_torch.core.pack import packed_nbytes, unpack_codes_rows
from repro_torch.core.spec import as_spec
from repro_torch.kernels import build, ref, tables

SMALL_M = 16        # rows up to which the decode shape runs (split K)
STRIP = 256         # output columns per f32 decode block
MAX_SPLIT_CHUNKS = 24   # 32-row chunks per split: the f32 decode block's
#                         slice of A (<= 16 rows) fits 48 KB of shared memory


def _is_packed(spec, k: int, kc: int) -> bool:
    """Packedness from the code rows, as the reference infers it."""
    if kc == k:
        return False
    if spec.format.code_bits < 8 and kc == packed_nbytes(spec.fmt, k):
        return True
    raise ValueError(
        f"codes have {kc} rows; expected K={k} (unpacked) or "
        f"storage_nbytes(K)={packed_nbytes(spec.fmt, k)} (bit-packed) for "
        f"fmt={spec.fmt}")


def split_count(n: int, k: int, sms: int) -> int:
    """How K is grouped: into this many consecutive runs of whole 32-row
    chunks.  Chosen so the f32 decode kernel's 256-column strips times
    the splits cover the card about four times, with at least two and at
    most 24 chunks per split.  The count depends on N and K only, never on
    M.  Within one activation dtype both shapes sum K in these groups and
    add the group sums in split order on the same instructions — bf16:
    mma.sync bf16 -> f32 in the decode and prefill shapes of
    csrc/mx_matmul_tc.cu; f32: FMAs in the two kernels of
    csrc/mx_matmul.cu — so every output row gets the same value whatever
    the batch."""
    chunks = k // 32
    strips = -(-n // STRIP)
    want = -(-4 * sms // strips)
    splits = max(1, min(want, chunks // 2))
    splits = max(splits, -(-chunks // MAX_SPLIT_CHUNKS))
    per = -(-chunks // splits)
    return -(-chunks // per)


def mx_matmul_2d(a: torch.Tensor, codes: torch.Tensor,
                 scales: torch.Tensor, spec) -> torch.Tensor:
    """a (M, K) f32/bf16 @ dequant(codes, scales) -> (M, N) f32.  codes are
    (K, N) u8, or bit-packed along K to (storage_nbytes(K), N); scales
    (K/32, N).  K must be a multiple of the block."""
    spec = as_spec(spec)
    if a.dim() != 2 or codes.dim() != 2 or scales.dim() != 2:
        raise ValueError("mx_matmul_2d takes 2-D a, codes and scales")
    m, k = a.shape
    kc, n = codes.shape
    if k % spec.block or tuple(scales.shape) != (k // spec.block, n):
        raise ValueError(f"mx_matmul_2d: K={k} must be a multiple of "
                         f"block={spec.block} and scales must be "
                         f"{(k // spec.block, n)}, got {tuple(scales.shape)}")
    packed = _is_packed(spec, k, kc)
    if a.device.type == "cpu":
        c = unpack_codes_rows(codes, spec.fmt, k) if packed else codes
        return ref.mx_matmul_2d_ref(a, c, scales, spec)
    if a.device.type != "cuda":
        raise ValueError(f"mx_matmul_2d: unsupported device {a.device}")
    if codes.device != a.device or scales.device != a.device:
        raise ValueError("mx_matmul_2d: a, codes and scales must share a "
                         "device")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mx_matmul_2d: a must be float32 or bfloat16, "
                         f"got {a.dtype}")
    if codes.dtype != torch.uint8 or scales.dtype != torch.uint8:
        raise ValueError("mx_matmul_2d: codes and scales must be uint8")
    if not (a.is_contiguous() and codes.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("mx_matmul_2d: operands must be contiguous")
    if n % 4 or codes.data_ptr() % 4 or scales.data_ptr() % 4 \
            or a.data_ptr() % 16:
        raise ValueError("mx_matmul_2d: the kernel reads 4 columns per "
                         "word: N must be a multiple of 4, codes and scales "
                         "4-byte aligned and a 16-byte aligned")
    if spec.block != 32:
        raise ValueError(f"mx_matmul_2d: the kernel supports block=32, "
                         f"got {spec}")
    dev = a.device
    kind = tables.pack_kind(spec) if packed else 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = split_count(n, k, sms)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    staged = m <= SMALL_M and splits > 1       # decode: split-K partials
    partial = torch.empty((splits, m, n) if staged else (1,),
                          dtype=torch.float32, device=dev)
    launch = build.lib().mx_matmul_tc_launch if a.dtype == torch.bfloat16 \
        else build.lib().mx_matmul_launch
    err = launch(
        a.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        tables.elem_table(spec, dev).data_ptr(),
        tables.scale_table(dev).data_ptr(), out.data_ptr(),
        partial.data_ptr(), m, n, k, kind, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mx_matmul_2d")
    mx_matmul_2d.launches += 1
    by = mx_matmul_2d.launches_by_spec
    by[spec] = by.get(spec, 0) + 1
    return out


mx_matmul_2d.launches = 0
mx_matmul_2d.launches_by_spec = {}     # QuantSpec -> launches
