"""The CUDA converter's per-element float encoders, emulated on the CPU,
against the plain converter's step sequence: bit for bit.

``csrc/mx_quant_common.cuh`` encodes an element in fewer integer
operations than ``core/convert.py`` (the reference's sequence, which the
port's plain version repeats and ``tests/test_torch_core.py`` holds
against the JAX package): the rounded significand is added onto the
exponent field, so a mantissa carry and a subnormal rounding up to the
smallest normal need no step of their own, OCP rounding is one
add-half-minus-one-plus-lsb, and saturation is a min() over codes, which
are ordered like their values.  This file writes those expressions out in
torch int32, line for line as the header has them, and compares them with
``core.convert._quant_float_paper`` / ``_quant_float_ocp`` on every
biased exponent of the element (0-255, NaN/Inf included) and every scale
code (0-255), over mantissas at each rounding boundary plus random ones.
The kernels themselves are held against the plain converter on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import convert as C
from repro_torch.core.formats import ALL_FORMATS

FLOAT_FMTS = [f for f in ALL_FORMATS if not f.is_int]


def _mantissas():
    m = {0, 0x7FFFFF}
    for k in range(23):
        m |= {1 << k, (1 << k) - 1, 0x7FFFFF ^ (1 << k)}
        if k:
            m.add((1 << k) | (1 << (k - 1)))
            m.add((1 << k) + (1 << (k - 1)) - 1)
    rng = np.random.default_rng(0)
    m |= set(int(x) for x in rng.integers(0, 1 << 23, size=40))
    return torch.tensor(sorted(m), dtype=torch.int32)


def _grid():
    """sign, exp, man, xs over exp x xs x mantissas (int32, flattened)."""
    man = _mantissas()
    e = torch.arange(256, dtype=torch.int32)
    x = torch.arange(256, dtype=torch.int32)
    exp, xs, man = (t.reshape(-1) for t in torch.meshgrid(
        e, x, man, indexing="ij"))
    sign = (man + exp) & 1
    return sign, exp, man, xs


def _paper(sign, exp, man, xs, f):
    """quant_float_paper of csrc/mx_quant_common.cuh."""
    R = f.mbits
    eb = exp - xs + f.bias
    rnd = ((man >> (22 - R)) + 1) >> 1
    body = torch.minimum((eb << R) + rnd,
                         torch.tensor((f.max_exp_paper << R) | ((1 << R) - 1),
                                      dtype=torch.int32))
    body = torch.where((eb <= 0) | (exp == 0), 0, body)
    return (sign << f.sign_shift) | body


def _ocp(sign, exp, man, xs, f):
    """quant_float_ocp of csrc/mx_quant_common.cuh."""
    R = f.mbits
    eb = exp - xs + f.bias
    sig = (1 << 23) | man
    shift = ((23 - R) + (1 - eb).clamp(min=0)).clamp(max=30)
    one = torch.ones_like(shift)
    q = (sig + (one << (shift - 1)) - 1 + ((sig >> shift) & 1)) >> shift
    body = torch.minimum(((eb.clamp(min=1) - 1) << R) + q,
                         torch.tensor((f.max_exp_ocp << R)
                                      | f.max_mant_at_top_ocp,
                                      dtype=torch.int32))
    body = torch.where(exp == 0, 0, body)
    return (sign << f.sign_shift) | body


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", [f.name for f in FLOAT_FMTS])
def test_kernel_encoder_matches_reference_sequence(fmt, mode):
    f = next(x for x in FLOAT_FMTS if x.name == fmt)
    sign, exp, man, xs = _grid()
    if mode == "paper":
        want = C._quant_float_paper(sign, exp, man, xs, f)
        got = _paper(sign, exp, man, xs, f)
    else:
        want = C._quant_float_ocp(sign, exp, man, xs, f)
        got = _ocp(sign, exp, man, xs, f)
    assert int(got.max()) < 256 and int(got.min()) >= 0
    bad = (got.to(torch.uint8) != want).nonzero()
    assert bad.numel() == 0, (
        f"{fmt} {mode}: first mismatch at exp {int(exp[bad[0]])}, xs "
        f"{int(xs[bad[0]])}, man {int(man[bad[0]]):#x}")
