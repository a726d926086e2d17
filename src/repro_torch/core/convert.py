"""FP32 -> MX conversion (the paper's three-step algorithm) in plain PyTorch.

Integer-exact twin of the converter: every step works on the
``x.view(torch.int32)`` bit pattern, so codes and scales are the same
bytes the hardware algorithm emits, and the CUDA converter
(``kernels/mx_quant.py``) is checked against this module bit for bit.

``mode="paper"`` — faithful to the paper: max biased exponent over the
finite elements; ``X = EV_max - bias`` clamped at 0 (NaN block -> 0xFF,
Inf block -> 0xFE); elements below the normal range flush to zero; R+1
kept mantissa bits rounded to R ties-away; a rounding carry at the top
exponent saturates.

``mode="ocp"`` — OCP MX v1.0: ``X = EV_max - emax_elem``, round to nearest
even with sticky bits, subnormal elements, saturation to max finite, INT8
as two's complement.

torch's uint32 support is thin, so every field stays in int32: a 32-bit
pattern is split with an arithmetic shift plus a mask.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import formats as F
from repro_torch.core.formats import MXFormat, get_format
from repro_torch.core.spec import MODES, QuantSpec, resolve_spec  # noqa: F401

_I32 = torch.int32

# the historical defaults of this module's entry points (paper mode)
_PAPER_DEFAULT = QuantSpec("e4m3", "paper")


# =============================================================================
# MXArray container
# =============================================================================
@dataclasses.dataclass
class MXArray:
    """A tensor quantized to MX format.

    ``codes``  uint8 — one element code per input value (low bits used for
               sub-byte formats; see core/pack.py for packed storage).
    ``scales`` uint8 — E8M0 shared scale, one per block along ``axis``.
    """

    codes: torch.Tensor
    scales: torch.Tensor
    fmt: str
    mode: str
    block: int
    orig_len: int            # unpadded length along the block axis
    axis: int                # axis (normalized, >= 0) blocks run along

    @classmethod
    def from_spec(cls, codes: torch.Tensor, scales: torch.Tensor, spec, *,
                  orig_len: Optional[int] = None,
                  axis: int = -1) -> "MXArray":
        """The validated constructor: checks the codes/scales shape
        contract before building the container."""
        from repro_torch.core.spec import as_spec
        spec = as_spec(spec)
        axis = axis % codes.dim()
        n = codes.shape[axis]
        if n % spec.block:
            raise ValueError(
                f"codes axis {axis} has length {n}, not a multiple of "
                f"block={spec.block}")
        want = list(codes.shape)
        want[axis] = n // spec.block
        if tuple(scales.shape) != tuple(want):
            raise ValueError(
                f"scales shape {tuple(scales.shape)} does not match codes "
                f"{tuple(codes.shape)} blocked by {spec.block} along axis "
                f"{axis} (expected {tuple(want)})")
        orig_len = n if orig_len is None else int(orig_len)
        if not (0 < orig_len <= n) or n - orig_len >= spec.block:
            raise ValueError(
                f"orig_len={orig_len} inconsistent with padded length {n}")
        return cls(codes=codes, scales=scales, fmt=spec.fmt, mode=spec.mode,
                   block=spec.block, orig_len=orig_len, axis=axis)

    @property
    def spec(self) -> QuantSpec:
        """The QuantSpec this array was quantized under.  ``packed`` reads
        False: MXArray codes are one byte per element whatever the
        quantizing spec's storage preference."""
        return QuantSpec(self.fmt, self.mode, self.block, packed=False)

    @property
    def format(self) -> MXFormat:
        return get_format(self.fmt)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The logical (unpadded) shape of the quantized tensor."""
        s = list(self.codes.shape)
        s[self.axis] = self.orig_len
        return tuple(s)

    @property
    def nbytes_logical(self) -> float:
        """Storage bytes under ideal bit-packing (codes plus the amortized
        E8M0 scale; roofline math)."""
        return math.prod(self.shape) * self.format.bits_per_element() / 8.0

    def dequantize(self) -> torch.Tensor:
        return mx_dequantize(self)


# =============================================================================
# Bit-level helpers
# =============================================================================
def _f32_fields(x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sign (i32 0/1), biased exponent (i32), 23-bit mantissa (i32)."""
    bits = x.to(torch.float32).contiguous().view(_I32)
    sign = (bits >> 31) & 1
    exp = (bits >> 23) & 0xFF
    man = bits & 0x7FFFFF
    return sign, exp, man


def _bits_to_f32(b: torch.Tensor) -> torch.Tensor:
    return b.to(_I32).contiguous().view(torch.float32)


def pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e as f32 for integer e in [-149, 127], incl. subnormals.

    Split into two in-range halves so each bit pattern is a normal f32."""
    e = e.to(_I32)
    e1 = e.clamp(-126, 127)
    e2 = e - e1                                  # residual in [-23, 0]
    return _bits_to_f32((e1 + 127) << 23) * _bits_to_f32((e2 + 127) << 23)


def scale_to_f32(scales: torch.Tensor) -> torch.Tensor:
    """Decode E8M0 scale codes to f32 (2^(X-127)); X=0 -> 2^-127."""
    return pow2_f32(scales.to(_I32) - F.SCALE_BIAS)


def _shl1(shift: torch.Tensor) -> torch.Tensor:
    """1 << shift for an int32 tensor of shift counts."""
    return torch.ones_like(shift) << shift


# =============================================================================
# Step 1 — largest power of two among the block (comparator tree)
# =============================================================================
def max_exponent_tree(exp_eff: torch.Tensor) -> torch.Tensor:
    """Pairwise max tree over the trailing (block) axis: the paper's
    5-level ``comp`` tree for block 32, one level per halving.
    Non-finite exclusion is the caller's (pass exponents already masked
    to 0).  ``quantize_blocks`` takes the same maximum with ``amax``."""
    x = exp_eff
    while x.shape[-1] > 1:
        x = torch.maximum(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def block_max_exponent(exp: torch.Tensor,
                       finite: torch.Tensor) -> torch.Tensor:
    """EV_max per block with non-finite inputs excluded (paper ``comp``)."""
    return max_exponent_tree(torch.where(finite, exp, 0))


# =============================================================================
# Step 2 — shared scale X
# =============================================================================
def shared_scale(ev_max: torch.Tensor, fmt: MXFormat, mode: str,
                 any_nan: torch.Tensor, any_inf: torch.Tensor
                 ) -> torch.Tensor:
    sub = fmt.bias if mode == "paper" else fmt.emax_ocp
    x = (ev_max - sub).clamp(min=0)
    x = x.clamp(max=0xFD if mode == "paper" else 0xFE)
    if mode == "paper":
        x = torch.where(any_inf, F.SCALE_INF, x)
        x = torch.where(any_nan, F.SCALE_NAN, x)
    else:
        x = torch.where(any_nan | any_inf, F.SCALE_NAN, x)
    return x.to(torch.uint8)


# =============================================================================
# Step 3 — per-element quantization
# =============================================================================
def _quant_float_paper(sign, exp, man, xblk, fmt: MXFormat) -> torch.Tensor:
    """Paper-mode EKMR element quantization (integer-exact)."""
    R = fmt.mbits
    eb = exp - xblk + fmt.bias                   # tentative biased elem exp
    kept = man >> (23 - (R + 1))                 # R+1 bits
    rnd = (kept + 1) >> 1                        # ties-away
    carry = rnd >> R
    mant = torch.where(carry > 0, 0, rnd) & fmt.mant_mask
    eb2 = eb + carry
    sat = eb2 > fmt.max_exp_paper
    mant = torch.where(sat, fmt.mant_mask, mant)
    eb2 = eb2.clamp(max=fmt.max_exp_paper)
    zero = (eb <= 0) | (exp == 0)                # FTZ; f32 zero/subnormal
    body = torch.where(zero, 0, (eb2 << R) | mant)
    return ((sign << fmt.sign_shift) | body).to(torch.uint8)


def _quant_float_ocp(sign, exp, man, xblk, fmt: MXFormat) -> torch.Tensor:
    """OCP-mode EKMR element quantization: full-sticky RNE + subnormals."""
    R = fmt.mbits
    eb = exp - xblk + fmt.bias
    sig = (1 << 23) | man                        # 24-bit significand
    sh_sub = (1 - eb).clamp(min=0)               # extra shift into subnormals
    shift = ((23 - R) + sh_sub).clamp(0, 30)
    low = sig & (_shl1(shift) - 1)
    half = _shl1(shift) >> 1
    q = sig >> shift
    round_up = (low > half) | ((low == half) & ((q & 1) == 1))
    q = q + round_up.to(_I32)
    ebn = eb.clamp(min=1)
    ncarry = q >> (R + 1)                        # 1 iff q == 2^(R+1)
    qn = torch.where(ncarry > 0, 1 << R, q)
    ebn = ebn + ncarry
    mant_n = qn - (1 << R)
    promote = q >> R                             # subnormal -> min normal
    mant_s = torch.where(promote > 0, 0, q)
    is_sub = eb <= 0
    mant = torch.where(is_sub, mant_s, mant_n)
    ebf = torch.where(is_sub, promote, ebn)
    top_e, top_m = fmt.max_exp_ocp, fmt.max_mant_at_top_ocp
    over = (ebf > top_e) | ((ebf == top_e) & (mant > top_m))
    mant = torch.where(over, top_m, mant)
    ebf = torch.where(over, top_e, ebf)
    body = torch.where(exp == 0, 0, (ebf << R) | mant)
    return ((sign << fmt.sign_shift) | body).to(torch.uint8)


def _quant_int8(sign, exp, man, xblk, mode: str) -> torch.Tensor:
    """INT8 element: value = m * 2^(X-127), m has 6 fractional bits."""
    e_u = exp - xblk                             # unbiased scaled exponent
    sig = (1 << 23) | man
    shift = (17 - e_u).clamp(0, 30)
    low = sig & (_shl1(shift) - 1)
    half = _shl1(shift) >> 1
    q = sig >> shift
    if mode == "paper":                          # ties-away
        q = q + ((low >= half) & (half > 0)).to(_I32)
    else:                                        # RNE
        q = q + ((low > half) | ((low == half) & ((q & 1) == 1))).to(_I32)
    q = torch.where(exp == 0, 0, q)              # FP32 zero/subnormal
    if mode == "paper":                          # sign-magnitude
        return ((sign << 7) | q.clamp(max=127)).to(torch.uint8)
    signed = torch.where(sign == 1, -q, q).clamp(-128, 127)
    return (signed & 0xFF).to(torch.uint8)       # two's complement byte


def _marker_codes(sign, fmt: MXFormat, kind: str) -> torch.Tensor:
    """Paper NaN/Inf element markers: top exponent + nan_mantissa / 0."""
    if fmt.is_int:
        mag = 127 if kind == "nan" else 126
        return ((sign << 7) | mag).to(torch.uint8)
    mant = fmt.nan_mantissa if kind == "nan" else 0
    body = (fmt.exp_mask << fmt.mbits) | mant
    return ((sign << fmt.sign_shift) | body).to(torch.uint8)


# =============================================================================
# Public API
# =============================================================================
def quantize_blocks(xg: torch.Tensor, fmt: MXFormat, mode: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize f32 (..., nblk, block) -> codes u8 (same shape) and
    scales u8 (..., nblk): the three steps on the grouped view."""
    sign, exp, man = _f32_fields(xg)
    finite = exp != 0xFF
    any_nan = ((~finite) & (man != 0)).any(dim=-1)
    any_inf = ((~finite) & (man == 0)).any(dim=-1)
    ev_max = torch.where(finite, exp, 0).amax(dim=-1)            # step 1
    xscale = shared_scale(ev_max, fmt, mode, any_nan, any_inf)   # step 2
    xblk = xscale.to(_I32)[..., None]
    if fmt.is_int:                                               # step 3
        codes = _quant_int8(sign, exp, man, xblk, mode)
    elif mode == "paper":
        codes = _quant_float_paper(sign, exp, man, xblk, fmt)
    else:
        codes = _quant_float_ocp(sign, exp, man, xblk, fmt)
    if mode == "paper":
        # NaN/Inf markers poison the whole block (paper div/P_i rules)
        codes = torch.where(any_inf[..., None],
                            _marker_codes(sign, fmt, "inf"), codes)
        codes = torch.where(any_nan[..., None],
                            _marker_codes(sign, fmt, "nan"), codes)
    return codes, xscale


def mx_quantize(x: torch.Tensor, spec=None, mode: Optional[str] = None,
                block: Optional[int] = None, axis: int = -1, *,
                fmt: Optional[str] = None) -> MXArray:
    """Convert a float tensor to MX format along ``axis`` (paper steps
    1-3), in plain PyTorch on whatever device ``x`` lies.  ``spec`` is a
    QuantSpec or spec string; the default is ``e4m3@32:paper``."""
    spec = resolve_spec(spec, fmt, mode, block, default=_PAPER_DEFAULT,
                        caller="mx_quantize")
    f, block = spec.format, spec.block
    axis = axis % x.dim()
    xb = x.to(torch.float32).movedim(axis, -1)
    n = xb.shape[-1]
    pad = (-n) % block
    if pad:
        xb = torch.nn.functional.pad(xb, (0, pad))
    lead = xb.shape[:-1]
    nblk = xb.shape[-1] // block
    codes, scales = quantize_blocks(xb.reshape(lead + (nblk, block)), f,
                                    spec.mode)
    codes = codes.reshape(lead + (nblk * block,)).movedim(-1, axis)
    scales = scales.movedim(-1, axis)
    return MXArray.from_spec(codes.contiguous(), scales.contiguous(), spec,
                             orig_len=n, axis=axis)


def decode_elements(codes: torch.Tensor, fmt: MXFormat,
                    mode: str) -> torch.Tensor:
    """Element code -> f32 value relative to the scale (no scale applied).
    The value is a function of the code byte alone, so the 256 bytes are
    decoded (``_decode_bytes``) and each code looks its value up: the
    same bits as decoding every element, at one gather's cost."""
    table = _decode_bytes(torch.arange(256, dtype=_I32, device=codes.device),
                          fmt, mode)
    return table[codes.long()]


def _decode_bytes(c: torch.Tensor, fmt: MXFormat, mode: str) -> torch.Tensor:
    """``decode_elements`` by arithmetic on int32 codes ``c``."""
    if fmt.is_int:
        if mode == "paper":                      # sign-magnitude 1.6
            mag = (c & 0x7F).to(torch.float32) / 64.0
            return torch.where(((c >> 7) & 1) == 1, -mag, mag)
        i8 = torch.where(c >= 128, c - 256, c)   # two's complement
        return i8.to(torch.float32) / 64.0
    R, bias = fmt.mbits, fmt.bias
    sign = (c >> fmt.sign_shift) & 1
    e = (c >> R) & fmt.exp_mask
    m = c & fmt.mant_mask
    frac = m.to(torch.float32) / float(1 << R)
    if mode == "ocp":
        val = torch.where(e == 0,
                          frac * pow2_f32(torch.full_like(e, 1 - bias)),
                          (1.0 + frac) * pow2_f32(e - bias))
        if fmt.has_ieee_specials:
            top = e == fmt.exp_mask
            val = torch.where(top & (m == 0), torch.inf, val)
            val = torch.where(top & (m != 0), torch.nan, val)
        if fmt.e4m3_style_nan:
            val = torch.where((e == fmt.exp_mask) & (m == fmt.mant_mask),
                              torch.nan, val)
    else:
        # paper: exp==0 codes are true zeros (FTZ); no subnormals
        val = torch.where(e == 0, 0.0, (1.0 + frac) * pow2_f32(e - bias))
        top = e == fmt.exp_mask                  # paper marker space
        val = torch.where(top & (m == 0), torch.inf, val)
        val = torch.where(top & (m != 0), torch.nan, val)
    return torch.where(sign == 1, -val, val)


def mx_dequantize(mx: MXArray) -> torch.Tensor:
    """MXArray -> f32 tensor (the backward transformation)."""
    f = mx.format
    codes = mx.codes.movedim(mx.axis, -1)
    scales = mx.scales.movedim(mx.axis, -1)
    lead = codes.shape[:-1]
    nblk = scales.shape[-1]
    cg = codes.reshape(lead + (nblk, mx.block))
    val = decode_elements(cg, f, mx.mode) * scale_to_f32(scales)[..., None]
    if mx.mode == "paper":
        val = torch.where((scales == F.SCALE_NAN)[..., None], torch.nan,
                          val)
        neg = ((cg.to(_I32) >> f.sign_shift) & 1) == 1
        sgn_inf = torch.where(neg, -torch.inf, torch.inf)
        val = torch.where((scales == F.SCALE_INF)[..., None], sgn_inf, val)
    else:
        val = torch.where((scales == F.SCALE_NAN)[..., None], torch.nan,
                          val)
    val = val.reshape(lead + (nblk * mx.block,))[..., :mx.orig_len]
    return val.movedim(-1, mx.axis)


def quantize_dequantize(x: torch.Tensor, spec=None,
                        mode: Optional[str] = None,
                        block: Optional[int] = None,
                        axis: int = -1) -> torch.Tensor:
    """The quantize -> dequantize round trip in f32 (fake quantization;
    the calibration sweep scores candidate specs with it)."""
    spec = resolve_spec(spec, None, mode, block, default=_PAPER_DEFAULT,
                        caller="quantize_dequantize")
    return mx_dequantize(mx_quantize(x, spec, axis=axis))


def mx_error_bound(spec="e4m3", mode: Optional[str] = None) -> float:
    """Worst-case |dequant(quant(v)) - v| relative to the block's largest
    element: 2^-mbits for the float formats (one ulp at the block's top
    binade), 2^-6 for INT8.  Depends only on the element format; ``mode``
    is the reference's legacy no-op."""
    del mode
    if isinstance(spec, QuantSpec):
        f = spec.format
    elif isinstance(spec, MXFormat):
        f = spec
    else:
        f = get_format(QuantSpec.parse(spec).fmt)
    if f.is_int:
        return 2.0 ** (-f.int_frac_bits)
    return 2.0 ** (-f.mbits)
