"""The port's core and ops leftovers against the JAX package: the
``MXArray`` views, ``quantize_dequantize``, ``mx_error_bound``,
``core.metrics``, ``ops.mx_matmul`` on an ``MXArray``,
``ops.quantize_weight`` and the ``mode`` / ``block`` keywords of
``ops.mx_quantize``; with cases of tests/test_mx_golden.py and
tests/test_metrics.py run on the port.  Inputs come from a numpy seed;
codes and scales must match bit for bit, floats within 1e-6 relative
(matmul: 1e-5, f32 sums in another order).  Round trips are compared
where no scale code is 0 (ROADMAP C1)."""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import (ALL_FORMATS, MXArray, QuantSpec,
                              mx_dequantize, mx_error_bound, mx_quantize,
                              quantize_dequantize)
from repro_torch.core import metrics
from repro_torch.core.formats import SCALE_INF, SCALE_NAN
from repro_torch.kernels import ops

torch.set_num_threads(1)

FMTS = [f.name for f in ALL_FORMATS]
MODES = ["paper", "ocp"]


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def quiet_shims():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


# =============================================================================
# MXArray views, the round trip, the error bound
# =============================================================================
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("mode", MODES)
def test_mxarray_views_match_jax(fmt, mode):
    from repro.core import QuantSpec as JSpec
    from repro.core import mx_quantize as j_quantize
    spec = f"{fmt}@32:{mode}"
    x = _x((3, 70, 5), seed=1)
    jm = j_quantize(x, JSpec.parse(spec), axis=1)
    mx = mx_quantize(_t(x), QuantSpec.parse(spec), axis=1)
    assert mx.shape == tuple(jm.shape) == (3, 70, 5)
    assert str(mx.spec) == str(jm.spec) and mx.spec.packed is False
    assert mx.nbytes_logical == jm.nbytes_logical
    np.testing.assert_array_equal(mx.codes.numpy(), np.asarray(jm.codes))
    np.testing.assert_array_equal(mx.scales.numpy(), np.asarray(jm.scales))
    assert int(mx.scales.min()) > 0
    np.testing.assert_allclose(mx.dequantize().numpy(),
                               np.asarray(jm.dequantize()), rtol=1e-6)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("mode", MODES)
def test_quantize_dequantize_matches_jax(fmt, mode):
    from repro.core import QuantSpec as JSpec
    from repro.core import quantize_dequantize as j_qdq
    spec = f"{fmt}@32:{mode}"
    x = _x((8, 96), seed=2, scale=3.0)
    want = np.asarray(j_qdq(x, JSpec.parse(spec), axis=-1))
    got = quantize_dequantize(_t(x), QuantSpec.parse(spec), axis=-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the reference's keyword form (bare format, mode=, block=) gives the
    # same round trip
    np.testing.assert_array_equal(
        quantize_dequantize(_t(x), fmt, mode=mode, block=32).numpy(),
        got.numpy())


@pytest.mark.parametrize("fmt", FMTS)
def test_mx_error_bound_matches_jax(fmt):
    from repro.core import QuantSpec as JSpec
    from repro.core import get_format as j_format
    from repro.core import mx_error_bound as j_bound
    from repro_torch.core import get_format
    spec = f"{fmt}@32:ocp"
    want = j_bound(JSpec.parse(spec))
    assert mx_error_bound(QuantSpec.parse(spec)) == want
    assert mx_error_bound(spec) == j_bound(spec) == want
    assert mx_error_bound(get_format(fmt)) == j_bound(j_format(fmt)) == want
    assert mx_error_bound(spec, mode="paper") == want


# =============================================================================
# golden cases of tests/test_mx_golden.py on the port
# =============================================================================
def _golden_block():
    def f32(sign, exp, man23):
        return np.uint32((sign << 31) | (exp << 23) | man23).view(
            np.float32)
    x = np.zeros(32, np.float32)
    x[:4] = [f32(0, 0b10101011, 0b011 << 20), f32(0, 0b10101000, 0b110 << 20),
             f32(0, 0b00101011, 0b001 << 20), f32(1, 0b10001111, 0b001 << 20)]
    return x


def test_golden_block_codes_and_values():
    """The paper's worked example (e5m2, paper mode): scale 0x9C, private
    elements P1-P4 (the corrected sign rule) and their values."""
    x = _golden_block()
    mx = ops.mx_quantize(_t(x), "e5m2", mode="paper")
    assert int(mx.scales.reshape(-1)[0]) == 0x9C
    codes = mx.codes.reshape(-1).tolist()[:4]
    assert codes == [0b01111010, 0b01101111, 0, 0b10001001]
    y = mx.dequantize().reshape(-1).numpy()
    scale = 2.0 ** (0x9C - 127)
    assert y[0] == pytest.approx((1 + 2 / 4) * 2.0 ** 15 * scale)
    assert y[1] == pytest.approx((1 + 3 / 4) * 2.0 ** 12 * scale)
    assert y[2] == 0.0
    assert y[3] == pytest.approx(-(1 + 1 / 4) * 2.0 ** -13 * scale)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["nan", "inf", "zero"])
def test_marker_and_zero_blocks(fmt, mode, kind):
    """A NaN block gets the 0xFF scale, an Inf block 0xFE in paper mode
    (NaN in ocp), an all-zero block scale 0 and zero codes; through the
    bare format and ``mode`` keyword of ``ops.mx_quantize``."""
    x = np.zeros(32, np.float32) if kind == "zero" \
        else np.linspace(-4.0, 4.0, 32).astype(np.float32)
    if kind == "nan":
        x[5] = np.nan
    elif kind == "inf":
        x[3], x[7] = np.inf, -np.inf
    mx = ops.mx_quantize(_t(x), fmt, mode=mode)
    scale = int(mx.scales.reshape(-1)[0])
    y = mx_dequantize(mx).numpy()
    if kind == "zero":
        assert scale == 0 and int(mx.codes.max()) == 0
        np.testing.assert_array_equal(y, x)
    elif kind == "inf" and mode == "paper":
        assert scale == SCALE_INF
        assert y[3] == np.inf and y[7] == -np.inf
        assert (np.signbit(y) == np.signbit(x)).all()
    else:
        assert scale == SCALE_NAN and np.isnan(y).all()


# =============================================================================
# metrics, against the JAX package and the goldens of tests/test_metrics.py
# =============================================================================
@pytest.mark.parametrize("d, block", [(64, 32), (96, 32), (8, 32),
                                      (40, 16)],
                         ids=["two-blocks", "three-blocks", "short-row",
                              "ragged"])
def test_metrics_match_jax(d, block):
    from repro.core import metrics as jm
    x = _x((6, d), seed=4)
    xq = x + _x((6, d), seed=5, scale=1e-2)
    for name in ("sqnr_db", "mse"):
        np.testing.assert_allclose(
            float(getattr(metrics, name)(_t(x), _t(xq))),
            float(getattr(jm, name)(x, xq)), rtol=1e-6, err_msg=name)
    got = float(metrics.max_rel_err_vs_blockmax(_t(x), _t(xq), block))
    want = float(jm.max_rel_err_vs_blockmax(x, xq, block))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_metric_goldens():
    x = _t(np.tile([1.0, 0.5, 2.0, 4.0], 8).astype(np.float32))
    for fmt in ("e4m3", "e2m1", "int8"):
        xq = quantize_dequantize(x, QuantSpec(fmt, "ocp", 32))
        assert float(metrics.sqnr_db(x, xq)) > 100.0, fmt
    v = np.float32(1.0 / 3.0)
    xc = torch.full((32,), float(v))
    xq = quantize_dequantize(xc, QuantSpec("int8", "ocp", 32))
    np.testing.assert_array_equal(xq.numpy(), np.float32(85.0 / 256.0))
    np.testing.assert_allclose(
        float(metrics.sqnr_db(xc, xq)),
        10.0 * np.log10(float(v) ** 2 / (float(v) - 85.0 / 256.0) ** 2),
        rtol=1e-5)
    assert float(metrics.mse(torch.zeros(10), torch.full((10,), 2.0))) \
        == 4.0
    e = np.zeros((2, 32), np.float32)
    e[:, 0] = 8.0
    eq = e.copy()
    eq[1, 5] = 0.5
    np.testing.assert_allclose(
        float(metrics.max_rel_err_vs_blockmax(_t(e), _t(eq))), 0.5 / 8.0,
        rtol=1e-6)
    row = _t(np.array([4.0, 1.0, 0, 0, 0, 0, 0, 2.0], np.float32))
    rq = row.clone()
    rq[1] = 0.0
    assert float(metrics.max_rel_err_vs_blockmax(row, rq)) == 0.25
    assert float(metrics.max_rel_err_vs_blockmax(row, row)) == 0.0


# =============================================================================
# ops: quantize_weight, mx_matmul on an MXArray, mx_quantize keywords
# =============================================================================
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("k", [96, 80], ids=["k96", "k80-padded"])
def test_quantize_weight_and_mx_matmul_match_jax(fmt, k):
    from repro.core import QuantSpec as JSpec
    from repro.kernels import ops as jops
    spec = f"{fmt}@32:ocp"
    w = _x((k, 24), seed=6) / np.sqrt(k)
    a = _x((5, k), seed=7)
    jw = jops.quantize_weight(w, JSpec.parse(spec))
    mw = ops.quantize_weight(_t(w), QuantSpec.parse(spec))
    assert isinstance(mw, MXArray) and mw.axis == 0 and mw.shape == (k, 24)
    np.testing.assert_array_equal(mw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(mw.scales.numpy(), np.asarray(jw.scales))
    got = ops.mx_matmul(_t(a), mw)
    want = np.asarray(jops.mx_matmul(a, jw)) if k % 32 == 0 \
        else a @ np.asarray(jw.dequantize())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), a @ mw.dequantize().numpy(), rtol=1e-5, atol=1e-5)


def test_mx_matmul_refuses_other_axes():
    mx = mx_quantize(_t(_x((4, 64))), QuantSpec("e4m3", "ocp"), axis=-1)
    with pytest.raises(ValueError, match="axis 0"):
        ops.mx_matmul(_t(_x((2, 4))), mx)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", [32, 16])
def test_mx_quantize_keywords_match_jax(mode, block):
    """``ops.mx_quantize`` with the reference's deprecated keywords gives
    the bytes of the spec form and of the JAX ``mx_quantize_pallas``."""
    from repro.kernels.ops import mx_quantize_pallas
    x = _x((6, 80), seed=8)
    spec = QuantSpec("e3m2", mode, block)
    by_kw = ops.mx_quantize(_t(x), "e3m2", mode=mode, block=block)
    by_spec = ops.mx_quantize(_t(x), spec)
    jm = mx_quantize_pallas(x, fmt="e3m2", mode=mode, block=block)
    for got in (by_kw, by_spec):
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(jm.codes))
        np.testing.assert_array_equal(got.scales.numpy(),
                                      np.asarray(jm.scales))
    with pytest.raises(TypeError, match="not both"):
        ops.mx_quantize(_t(x), spec, mode="paper")
