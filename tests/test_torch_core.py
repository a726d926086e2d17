"""The port's core (converter, decode, packing, MXWeight) against the JAX
package, bit for bit.

Inputs are made with numpy from a seed and fed to both sides; codes,
scales and packed bytes must be identical.  The one documented deviation
(ROADMAP C1): JAX's CPU backend flushes f32 subnormals, so E8M0 scale
code 0 decodes to 0.0 there and to the IEEE value 2^-127 in the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convert as jconv
from repro.core import mx_weight as jmw
from repro.core import pack as jpack
from repro.core.formats import ALL_FORMATS
from repro_torch.core import convert as tconv
from repro_torch.core import mx_weight as tmw
from repro_torch.core import pack as tpack

torch.set_num_threads(1)

FMTS = [f.name for f in ALL_FORMATS]
SUB_BYTE = ["e2m1", "e3m2", "e2m3"]


def _inputs(seed=0):
    """Rows of every kind the converter must handle, 96 wide."""
    rng = np.random.default_rng(seed)
    n = 96
    rows = [rng.normal(size=(4, n)),                        # normal
            rng.standard_cauchy(size=(4, n)) * 1e3,         # heavy-tailed
            np.zeros((1, n)),                               # zeros
            rng.normal(size=(2, n)) * 1e-39,                # f32 subnormals
            rng.normal(size=(8, n)) * np.exp2(
                rng.integers(-140, 125, size=(8, n)))]      # wide exponents
    x = np.concatenate(rows).astype(np.float32)
    x[0, 3] = np.inf
    x[1, 40] = np.nan
    x[2, 70] = -np.inf
    x[3, :32] = np.float32(1e-45) * np.arange(32)           # tiny subnormals
    return x


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_mx_quantize_bit_identical(fmt, mode):
    x = _inputs()
    spec = f"{fmt}@32:{mode}"
    # 77: not a multiple of 32; axis 0: blocks along the leading axis
    for n, axis in ((96, -1), (77, -1), (77, 0)):
        xs = x[:, :n] if axis == -1 else x[:, :n].T.copy()
        j = jconv.mx_quantize(jnp.asarray(xs), spec, axis=axis)
        t = tconv.mx_quantize(torch.from_numpy(xs.copy()), spec, axis=axis)
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.scales.numpy(),
                                      np.asarray(j.scales))
        assert (t.orig_len, t.axis) == (j.orig_len, j.axis)


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_decode_elements_all_codes_bit_identical(fmt, mode):
    f = next(ff for ff in ALL_FORMATS if ff.name == fmt)
    codes = np.arange(256, dtype=np.uint8)
    j = np.asarray(jconv.decode_elements(jnp.asarray(codes), f, mode))
    t = tconv.decode_elements(torch.from_numpy(codes), f, mode).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


def test_scale_to_f32():
    s = np.arange(256, dtype=np.uint8)
    j = np.asarray(jconv.scale_to_f32(jnp.asarray(s)))
    t = tconv.scale_to_f32(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(t[1:255], j[1:255])
    assert t[0] == np.float32(2.0 ** -127)   # IEEE value (ROADMAP C1)
    assert np.isinf(t[255]) and np.isinf(j[255])


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_mx_dequantize_matches(fmt, mode):
    """Round trip of normal-range data (no scale code 0) matches bit for
    bit, NaN/Inf markers included."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(19, 96)).astype(np.float32)   # shape of _inputs
    x[0, 5], x[1, 9] = np.nan, -np.inf
    spec = f"{fmt}@32:{mode}"
    j = np.asarray(jconv.mx_dequantize(jconv.mx_quantize(jnp.asarray(x),
                                                         spec)))
    t = tconv.mx_dequantize(tconv.mx_quantize(torch.from_numpy(x), spec))
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("fmt", SUB_BYTE)
def test_pack_unpack_bit_identical(fmt):
    bits = next(f.code_bits for f in ALL_FORMATS if f.name == fmt)
    rng = np.random.default_rng(2)
    c = rng.integers(0, 2 ** bits, size=(3, 64, 96)).astype(np.uint8)
    # trailing axis (KV pages)
    jp = np.asarray(jpack.pack_codes(jnp.asarray(c), fmt))
    tp = tpack.pack_codes(torch.from_numpy(c), fmt).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(
        tpack.unpack_codes(torch.from_numpy(tp), fmt, 96).numpy(), c)
    # axis -2 (weight rows)
    jr = np.asarray(jpack.pack_codes_rows(jnp.asarray(c), fmt))
    tr = tpack.pack_codes_rows(torch.from_numpy(c), fmt).numpy()
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(
        tpack.unpack_codes_rows(torch.from_numpy(tr), fmt, 64).numpy(), c)
    assert tr.shape[-2] == tpack.packed_nbytes(fmt, 64)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fmt", FMTS)
def test_mxweight_quantize_identical(fmt, packed):
    from repro.core.spec import QuantSpec as JSpec
    from repro_torch.core.spec import QuantSpec as TSpec
    rng = np.random.default_rng(3)
    # K = 77 is padded to a block multiple; (77, 19) along axis 0 is a
    # shape the converter test already compiled on the JAX side
    w = (rng.normal(size=(77, 19)) * 0.05).astype(np.float32)
    j = jmw.MXWeight.quantize(jnp.asarray(w), JSpec(fmt, "ocp", 32, packed))
    t = tmw.MXWeight.quantize(torch.from_numpy(w),
                              TSpec(fmt, "ocp", 32, packed))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert (t.packed, t.k, t.n, t.kp) == (j.packed, j.k, j.n, j.kp)
    np.testing.assert_array_equal(t.dequantize().numpy(),
                                  np.asarray(j.dequantize()))
