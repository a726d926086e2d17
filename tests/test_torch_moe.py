"""The port's capacity-routed MoE layer and MX expert stacks against the
JAX package.

``layers.moe`` is held against ``repro.models.layers.moe`` on the reduced
moonshot-v1-16b-a3b widths (d 128, 8 experts of d_ff 64, top-2, 2 shared
experts), on fp expert stacks and on weight-resident ``MXWeight`` stacks
carried across byte for byte (``from_numpy``).  Inputs come from a numpy
seed.  The reference runs its weight-resident experts on the
dequant-einsum path (``REPRO_MX_MATMUL_IMPL=einsum``) and, in one case,
through its fused Pallas matmul in interpret mode, as its own tests run
it; the port runs its matmul kernel's plain version (CPU tensors).
Tolerance: outputs within 1e-5 of the reference (f32 sums in another
order; the layer primitives' tolerance in tests/test_torch_model.py), the
aux loss within 1e-6, and the routing (the top-k experts of every token)
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mx_weight import MXWeight as JMXWeight
from repro.core.mx_weight import mx_weight_nbytes as j_nbytes
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro_torch.core.mx_weight import MXWeight as TMXWeight
from repro_torch.core.mx_weight import mx_weight_nbytes as t_nbytes
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.models import layers as TL
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.params import from_numpy
from torch_parity import params_to_numpy

torch.set_num_threads(1)

ARCH = "moonshot_v1_16b_a3b"
FMTS = ("e5m2", "e4m3", "e3m2", "e2m3", "e2m1", "int8")
MODES = ("paper", "ocp")
TOL = 1e-5


@pytest.fixture
def einsum_matmul(monkeypatch):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")


def _moe_pair(policy="none", **over):
    """The reference's first MoE layer params (layer 1; layer 0 is
    dense) and their port twins, with both configs."""
    jcfg = j_load_reduced(ARCH, mx=JPolicy.parse(policy), **over)
    tcfg = t_load_reduced(ARCH, mx=TPolicy.parse(policy), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if jcfg.mx.weights is not None:
        jp = jax.jit(jm.quantize_weights)(jp)
    tp = from_numpy(params_to_numpy(jp), tcfg, "cpu")
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    return jcfg, tcfg, jlayer["moe"], tp["layers"][1]["moe"]


def _x(b, s, d=128, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _ref_topi(router, x, cfg):
    """The reference's routing (layers.py:913-917): top-k of the f32
    softmax over each token's router logits, grouped as it groups."""
    b, s, d = x.shape
    gs = min(JL.GROUP_SIZE, b * s)
    xt = jnp.asarray(x).reshape(b * s // gs, gs, d)
    logits = jnp.einsum("gsd,de->gse", xt.astype(jnp.float32),
                        jnp.asarray(router, jnp.float32))
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe_topk)
    return np.asarray(topi)


def _port_topi(router, x, cfg):
    b, s, d = x.shape
    g, gs, _ = TL.moe_groups(b * s, cfg)
    _, _, topi = TL.moe_route(router, torch.from_numpy(x).reshape(g, gs, d),
                              cfg.moe_topk)
    return topi.numpy()


@pytest.mark.parametrize("policy", ["none", "weights=e4m3@32:ocp",
                                    "weights=e2m1@32:ocp"])
@pytest.mark.parametrize("b,s", [(2, 32), (4, 64), (2, 256)])
def test_moe_matches_reference(einsum_matmul, policy, b, s):
    """n_tok 64, 256 and 512 (one group, one full group, two groups):
    outputs, aux loss and routing equal the reference's."""
    jcfg, tcfg, jp, tp = _moe_pair(policy)
    x = _x(b, s)
    jo, ja = JL.moe(jp, jnp.asarray(x), jcfg)
    to, ta = TL.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_port_topi(tp["router"], x, tcfg),
                                  _ref_topi(jp["router"], x, jcfg))
    if policy != "none":
        assert isinstance(tp["experts"]["w1"], TMXWeight)
        assert tp["experts"]["w1"].codes.shape[0] == tcfg.n_experts


def test_moe_matches_reference_fused_kernel():
    """The reference's weight-resident experts through its fused Pallas
    matmul (interpret mode), one call per expert via ``take``."""
    jcfg, tcfg, jp, tp = _moe_pair("weights=e4m3@32:ocp")
    x = _x(1, 16)
    jo, ja = JL.moe(jp, jnp.asarray(x), jcfg)
    to, ta = TL.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["none", "weights=e4m3@32:ocp"])
def test_moe_heavy_drop(einsum_matmul, policy):
    """Capacity 1 per expert and group (capacity_factor 0.01): most
    choices drop, and the port drops exactly the reference's."""
    jcfg, tcfg, jp, tp = _moe_pair(policy, capacity_factor=0.01)
    assert TL.moe_groups(128, tcfg)[2] == 1
    x = _x(2, 64, seed=3)
    jo, ja = JL.moe(jp, jnp.asarray(x), jcfg)
    to, ta = TL.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    # the routed part differs from a no-drop layer's: choices did drop
    nodrop = dataclasses.replace(tcfg, capacity_factor=64.0)
    free, _ = TL.moe(tp, torch.from_numpy(x), nodrop)
    assert not torch.allclose(free, to, atol=1e-3)


def test_moe_refuses_ragged_groups_as_the_reference_does():
    """288 tokens (3 prompts x a bucket of 96) are past one group of 256
    and no multiple of it: the reference's reshape fails, and the port
    raises ValueError at the same shape (ROADMAP C8)."""
    jcfg, tcfg, jp, tp = _moe_pair()
    x = _x(3, 96)
    with pytest.raises(TypeError, match="reshape"):
        JL.moe(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="C8"):
        TL.moe(tp, torch.from_numpy(x), tcfg)
    assert TL.moe_groups(256, tcfg)[:2] == (1, 256)
    assert TL.moe_groups(512, tcfg)[:2] == (2, 256)
    assert TL.moe_groups(96, tcfg)[:2] == (1, 96)


def test_topk_ties_take_the_lower_index():
    """Tied router probabilities (duplicated router columns, and a zero
    token whose probabilities all tie) pick the lower expert index, as
    ``lax.top_k`` does."""
    jcfg, tcfg, jp, tp = _moe_pair()
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 0]
    x = _x(1, 32, seed=5)
    x[0, :4] = 0.0
    got = _port_topi(torch.from_numpy(router), x, tcfg)
    want = _ref_topi(router, x, jcfg)
    np.testing.assert_array_equal(got, want)
    assert (got[0, :4] == [0, 1]).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FMTS)
def test_expert_stack_quantize_take_and_nbytes(fmt, mode):
    """An (E, K, N) expert stack quantized through the converter is bit
    for bit the reference's ``MXWeight.quantize`` of the same numpy
    input; ``take(i)`` is the reference's expert i, as a contiguous view
    of the stack's leaves; ``mx_weight_nbytes`` equals the reference's
    and the bytes ``take`` holds."""
    spec = f"{fmt}@32:{mode}"
    w = np.random.default_rng(7).standard_normal((4, 96, 40)).astype(
        np.float32) * np.float32(3.0)
    w[1, :32, 3] = 0.0
    jw = JMXWeight.quantize(jnp.asarray(w), spec)
    tw = TMXWeight.quantize(torch.from_numpy(w), spec)
    assert (tw.packed, tw.k, tw.n, tw.fmt, tw.mode) \
        == (jw.packed, jw.k, jw.n, jw.fmt, jw.mode)
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    for i in range(4):
        ti, ji = tw.take(i), jw.take(i)
        assert ti.codes.is_contiguous() and ti.scales.is_contiguous()
        assert ti.codes.data_ptr() == tw.codes.data_ptr() \
            + i * ti.codes.numel()
        np.testing.assert_array_equal(ti.codes.numpy(), np.asarray(ji.codes))
        np.testing.assert_array_equal(ti.scales.numpy(),
                                      np.asarray(ji.scales))
        np.testing.assert_array_equal(ti.dequantize().numpy(),
                                      np.asarray(ji.dequantize()))
        assert ti.nbytes == t_nbytes(96, 40, spec) == j_nbytes(96, 40, spec)
    for k in (32, 70, 1408):
        assert t_nbytes(k, 8, TSpec.parse(spec)) == j_nbytes(k, 8, spec)
