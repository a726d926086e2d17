"""The premise of the tensor-core MX matmul (csrc/mx_matmul_tc.cu).

That kernel rounds each dequantized weight ``elem * 2^(s-127)`` to bf16
and multiplies it by a bf16 activation on the tensor cores.  It computes
the reference's products exactly when every finite element value is a
bf16 and the folded product is one too.  These tests pin both, on the
CPU, for every format and mode, and pin the smallest scale code from
which the fold is exact (below it a weight can fall under bf16's smallest
subnormal, 2^-133): 10 for E5M2, 3 for E4M3, 0 for the rest.
"""
import pytest
import torch

from repro_torch.core.formats import ALL_FORMATS
from repro_torch.core.spec import QuantSpec
from repro_torch.kernels import tables

FMTS = [f.name for f in ALL_FORMATS]
SMALLEST_EXACT_SCALE = {"e5m2": 10, "e4m3": 3}


def _bf16_exact(x: torch.Tensor) -> bool:
    return bool((x.to(torch.bfloat16).to(torch.float32) == x).all())


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_folded_weights_are_exact_in_bf16(fmt, mode):
    elem = tables.elem_table(QuantSpec(fmt, mode), torch.device("cpu"))
    scale = tables.scale_table(torch.device("cpu"))
    fin = elem[torch.isfinite(elem)]
    assert fin.numel() >= 192
    assert _bf16_exact(fin)                    # every element is a bf16
    for s in range(10, 255):                   # every scale code >= 10
        assert _bf16_exact(fin * scale[s]), f"scale code {s}"
    exact = [_bf16_exact(fin * scale[s]) for s in range(255)]
    smallest = next(s for s in range(255) if all(exact[s:]))
    assert smallest == SMALLEST_EXACT_SCALE.get(fmt, 0)
    if fmt == "e5m2":                          # the bound of 10 is tight
        assert not exact[9]
