"""MX-format descriptors (paper Table I + OCP MX spec constants).

The paper considers six element formats sharing an 8-bit E8M0 scale per
32-element block: E5M2, E4M3, E3M2, E2M3, E2M1 and INT8.  ``MXFormat``
captures both the paper's parameterization (K exponent bits, R mantissa
bits, bias = 2^(K-1)-1) and the OCP MX spec constants (emax, max finite,
NaN/Inf encodability) needed for the spec-compliant "ocp" mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

SCALE_BITS = 8          # w: shared scale X is E8M0
SCALE_BIAS = 127        # X encodes 2^(X-127)
SCALE_NAN = 0xFF        # paper: X == 11111111 -> block is NaN
SCALE_INF = 0xFE        # paper: X == 11111110 -> block is +/-Inf marker
DEFAULT_BLOCK = 32      # n: paper converts 32 FP32 values per block


@dataclasses.dataclass(frozen=True)
class MXFormat:
    """One EKMR element format (sign bit implicit, per paper Table I)."""

    name: str
    ebits: int                 # K
    mbits: int                 # R
    is_int: bool = False       # INT8 is scaled fixed-point, not EKMR float
    emax_ocp: int = 0          # OCP spec emax of the element format
    nan_mantissa: int = 0      # paper's NaN marker mantissa (w/ top exponent)
    has_ieee_specials: bool = False  # ocp mode: top exponent reserved (E5M2)
    e4m3_style_nan: bool = False     # ocp mode: only S.1111.111 is NaN

    # ------------------------------------------------------------------ paper
    @property
    def bias(self) -> int:
        """Element exponent bias; the paper uses 2^(K-1)-1 (0 for INT8)."""
        return (1 << (self.ebits - 1)) - 1 if self.ebits > 1 else 0

    @property
    def code_bits(self) -> int:
        return 1 + self.ebits + self.mbits

    @property
    def max_exp_paper(self) -> int:
        """Largest biased element exponent the paper emits (2^K - 2)."""
        return (1 << self.ebits) - 2

    # -------------------------------------------------------------------- ocp
    @property
    def max_exp_ocp(self) -> int:
        """Largest biased exponent usable for finite values in ocp mode."""
        if self.has_ieee_specials:          # E5M2: top exponent = Inf/NaN
            return (1 << self.ebits) - 2
        return (1 << self.ebits) - 1        # E4M3/E3M2/E2M3/E2M1: no Inf

    @property
    def max_mant_at_top_ocp(self) -> int:
        """Largest mantissa allowed at max_exp_ocp (E4M3 reserves 111=NaN)."""
        full = (1 << self.mbits) - 1
        return full - 1 if self.e4m3_style_nan else full

    # ------------------------------------------------------------------ both
    @property
    def mant_mask(self) -> int:
        return (1 << self.mbits) - 1

    @property
    def exp_mask(self) -> int:
        return (1 << self.ebits) - 1

    @property
    def sign_shift(self) -> int:
        return self.ebits + self.mbits

    @property
    def int_frac_bits(self) -> int:
        """INT8: fractional bits of the 2's-complement / sign-magnitude value."""
        return self.mbits  # 6 for INT8 (value = m / 64)

    def bits_per_element(self) -> float:
        """Storage bits per element incl. the amortized shared scale."""
        return self.code_bits + SCALE_BITS / DEFAULT_BLOCK


E5M2 = MXFormat("e5m2", 5, 2, emax_ocp=15, nan_mantissa=0b10,
                has_ieee_specials=True)
E4M3 = MXFormat("e4m3", 4, 3, emax_ocp=8, nan_mantissa=0b111,
                e4m3_style_nan=True)
E3M2 = MXFormat("e3m2", 3, 2, emax_ocp=4, nan_mantissa=0b10)
E2M3 = MXFormat("e2m3", 2, 3, emax_ocp=2, nan_mantissa=0b110)
E2M1 = MXFormat("e2m1", 2, 1, emax_ocp=2, nan_mantissa=0b1)
INT8 = MXFormat("int8", 1, 6, is_int=True, emax_ocp=0)

FORMATS: Dict[str, MXFormat] = {
    f.name: f for f in (E5M2, E4M3, E3M2, E2M3, E2M1, INT8)
}

FP8_FORMATS: Tuple[MXFormat, ...] = (E5M2, E4M3)
FP6_FORMATS: Tuple[MXFormat, ...] = (E3M2, E2M3)
FP4_FORMATS: Tuple[MXFormat, ...] = (E2M1,)
ALL_FORMATS: Tuple[MXFormat, ...] = tuple(FORMATS.values())


def poison_threshold(mode: str) -> int:
    """Smallest E8M0 scale byte that marks a non-finite block under
    ``mode``.  Paper mode clamps legitimate scales to 0xFD and encodes
    Inf/NaN blocks as SCALE_INF/SCALE_NAN, so anything >= SCALE_INF is a
    marker; ocp mode uses the full 0xFE range for finite scales and folds
    both specials into SCALE_NAN.  A uint8 ``scale >= threshold`` compare
    is therefore a complete poison detector — no dequantization needed
    (the serving health guards rely on this)."""
    if mode not in ("paper", "ocp"):
        raise ValueError(f"unknown MX mode {mode!r}")
    return SCALE_INF if mode == "paper" else SCALE_NAN


def get_format(name: str | MXFormat) -> MXFormat:
    if isinstance(name, MXFormat):
        return name
    try:
        return FORMATS[name.lower()]
    except KeyError as e:
        raise ValueError(
            f"unknown MX format {name!r}; choose from {sorted(FORMATS)}"
        ) from e
