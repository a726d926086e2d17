"""Weight-resident MX storage: the serve-time weight container.

An ``MXWeight`` holds a matmul weight W (K, N) entirely in MX form:

  * ``codes``  uint8 — element codes along the contraction axis (axis -2),
    bit-packed with ``pack_codes_rows`` when the spec is packed and
    sub-byte, so device memory holds ``spec.storage_nbytes(K)`` byte rows;
  * ``scales`` uint8 — E8M0 shared scales, one per ``block`` rows:
    (Kp/32, N).

A stack of MoE expert weights (E, K, N) keeps its leading expert axis
on both leaves; ``take(i)`` is expert ``i``'s (K, N) weight as a view.

fp weights are never materialized on the serving path: the dequant x
matmul kernel (``kernels/mx_matmul.py``) decodes code tiles on chip.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.convert import MXArray, mx_dequantize
from repro_torch.core.pack import pack_codes_rows, unpack_codes_rows
from repro_torch.core.spec import QuantSpec, as_spec


@dataclasses.dataclass
class MXWeight:
    """A weight-resident MX matmul operand: packed codes + E8M0 scales."""
    codes: torch.Tensor      # (..., storage_nbytes(Kp), N) u8 if packed,
    #                          else (..., Kp, N) u8
    scales: torch.Tensor     # (..., Kp // block, N) u8
    fmt: str                 # element format name
    mode: str                # "paper" | "ocp"
    block: int               # codes per shared scale
    packed: bool             # sub-byte codes bit-packed along K
    k: int                   # logical (unpadded) contraction length
    n: int                   # output width

    @property
    def spec(self) -> QuantSpec:
        return QuantSpec(self.fmt, self.mode, self.block, self.packed)

    @property
    def kp(self) -> int:
        """Contraction length padded up to a block multiple."""
        return self.scales.shape[-2] * self.block

    @property
    def nbytes(self) -> int:
        """Device bytes as stored (codes + scales, one byte per element)."""
        return self.codes.numel() + self.scales.numel()

    @classmethod
    def quantize(cls, w: torch.Tensor, spec) -> "MXWeight":
        """Quantize W (..., K, N) along the contraction axis (-2) with the
        converter kernel (its plain version for a CPU tensor); leading
        axes (an expert stack's E) ride along."""
        from repro_torch.kernels.ops import mx_quantize
        spec = as_spec(spec)
        if w.dim() < 2:
            raise ValueError(f"MXWeight needs a (..., K, N) weight, "
                             f"got shape {tuple(w.shape)}")
        k, n = w.shape[-2], w.shape[-1]
        mx = mx_quantize(w.to(torch.float32), spec, axis=w.dim() - 2)
        codes = mx.codes
        packed = bool(spec.packed and spec.format.code_bits < 8)
        if packed:
            codes = pack_codes_rows(codes, spec.fmt)
        return cls(codes=codes, scales=mx.scales, fmt=spec.fmt,
                   mode=spec.mode, block=spec.block, packed=packed,
                   k=int(k), n=int(n))

    def take(self, i: int) -> "MXWeight":
        """Entry ``i`` of the leading axis (one MoE expert) as a (K, N)
        weight whose leaves are views of the stack's: contiguous, and
        4-byte aligned wherever the stack is and N is a multiple of 4,
        as the matmul kernel reads them."""
        return dataclasses.replace(self, codes=self.codes[i],
                                   scales=self.scales[i])

    def unpacked_codes(self) -> torch.Tensor:
        """Codes with the bit-packing undone: (..., Kp, N) u8."""
        if not self.packed:
            return self.codes
        return unpack_codes_rows(self.codes, self.fmt, self.kp)

    def dequantize(self) -> torch.Tensor:
        """Materialize the f32 weight (..., K, N) (tests and references
        only)."""
        codes = self.unpacked_codes()
        mx = MXArray.from_spec(
            codes, self.scales,
            QuantSpec(self.fmt, self.mode, self.block, packed=False),
            orig_len=self.k, axis=codes.dim() - 2)
        return mx_dequantize(mx)


def mx_weight_nbytes(k: int, n: int, spec) -> int:
    """Device bytes of one (K, N) weight stored per ``spec``:
    ``storage_nbytes`` bytes of codes per column plus one E8M0 byte per
    block of rows (packed E2M1 at block 32: 4.25 bits per weight)."""
    spec = as_spec(spec)
    kp = -(-k // spec.block) * spec.block
    return spec.storage_nbytes(kp) * n + (kp // spec.block) * n


def params_nbytes(params) -> int:
    """Total bytes of a param tree as stored (MXWeight leaves count their
    uint8 codes + scales; fp leaves count at their dtype width)."""
    if isinstance(params, MXWeight):
        return params.nbytes
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_nbytes(v) for v in params)
    raise TypeError(f"unexpected param leaf {type(params).__name__}")
