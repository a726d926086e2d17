"""The port's train step (``repro_torch.train``) against the JAX
package's (``repro.train``), on the reduced configs, from the same
params, optimizer state and batches (numpy; the reference's params and
state carried across by ``models.params.from_numpy`` /
``opt_state_from_numpy``).

Tolerances, each no looser than the reference's
``test_microbatched_matches_full_batch`` (rtol 2e-3, atol 2e-5):

* f32: loss, ``ce``, ``aux``, ``grad_norm`` and ``lr`` within rtol 1e-5
  (2e-3 under an ``activations`` role, where an activation's code can
  flip between the frameworks: see ``test_gradients_match_and_c9_set``);
  params, ``master``, ``m`` and ``v`` after the step within rtol 2e-3,
  atol 2e-5; gradients within 1e-4 of each leaf's largest element.
* bf16 (activations and gradients round to bf16 in each framework's
  own places; measured, the gradients of a leaf differ by 1-1.5% of its
  norm, and by up to 5% under ``weights+activations``, where a bf16 step
  of an activation can move its E4M3 code by one step): the scalars
  within rtol 2e-3; ``master`` within rtol 2e-3, atol 2e-5; the gradient
  each side folded into ``m`` and ``v`` ((m' - b1 m) / (1 - b1), and its
  square from ``v``) within 10% of the leaf's norm; the bf16 params are
  ``master`` rounded (exactly, on the port's side), so a param may
  differ from the reference's by the master tolerance plus one bf16
  step (where the two masters round apart), no more.

The step starts from random moments (``torch_parity.random_moments``):
a first step from zero moments moves each weight by about ``lr`` times
the sign of its gradient, and elements whose gradient is at the two
frameworks' rounding noise would move apart by ``2 lr``.

ROADMAP C9: the reference's fake quantizer passes no gradient (its
round trip runs on bitcast integers), so a weight reached only through
it has an all-zero gradient there and none (``None``) in the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import QuantPolicy as JPolicy
from repro.data import DataConfig, SyntheticLM, make_batch_for as j_batch
from repro.models import Model as JModel, load_reduced as j_load_reduced
from repro.optim import AdamWConfig as JAdamW
from repro.train import build_train_step as j_build, init_train_state
from repro.train.step import _loss_fn as j_loss_fn
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.models.params import from_numpy, opt_state_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.train import build_train_step
from repro_torch.train.step import _grads_of
from repro_torch.tree import leaves_with_path, path_key, tree_map
from torch_parity import params_to_numpy, random_moments

torch.set_num_threads(1)

QUANTS = {"none": "none", "weights": "weights=e4m3@32:ocp",
          "weights+activations":
              "weights=e4m3@32:ocp,activations=e4m3@32:ocp"}
CASES = [("chatglm3_6b", "float32"), ("chatglm3_6b", "bfloat16"),
         ("moonshot_v1_16b_a3b", "float32")]
OPT = dict(lr=2e-3, warmup_steps=5, total_steps=25)
B, S = 8, 32


def _pair(arch, dtype, quant, **over):
    """JAX and port models (flash attention on both, remat as the reduced
    config says: off) and the reference's params on both sides."""
    over = dict(dtype=dtype, param_dtype=dtype, attn_impl="flash", **over)
    jcfg = j_load_reduced(arch, mx=JPolicy.parse(quant), **over)
    tcfg = load_reduced(arch, mx=TPolicy.parse(quant), **over)
    jm, tm = JModel(jcfg), Model(tcfg, "cpu")
    jp, jo = init_train_state(jm, jax.random.PRNGKey(0))
    return jm, tm, jp, jo


def _port(tree, tcfg, dtype=None):
    return from_numpy(params_to_numpy(tree), tcfg, "cpu", dtype=dtype)


def _batch(vocab, step, seed=3):
    raw = SyntheticLM(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                 seed=seed)).batch(step)
    return raw, {k: torch.from_numpy(np.asarray(v)) for k, v in raw.items()}


def _close(got, want, rtol, atol, what):
    for (pg, g), (pw, w) in zip(leaves_with_path(got),
                                leaves_with_path(want)):
        assert pg == pw, (pg, pw)
        np.testing.assert_allclose(
            g.to(torch.float32).numpy(), w.to(torch.float32).numpy(),
            rtol=rtol, atol=atol, err_msg=f"{what} {path_key(pg)}")


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (its ulp)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("mb", [1, 4])
@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("arch,dtype", CASES)
def test_train_step_matches_reference(arch, dtype, quant, mb):
    """One ``build_train_step`` step at step 6 (lr past warm-up) from the
    reference's params and random moments: the metrics, params and
    AdamW state after it (tolerances in the module docstring)."""
    fq = quant != "none"
    jm, tm, jp, jo = _pair(arch, dtype, QUANTS[quant])
    jo = random_moments(jo)
    tp, to = _port(jp, tm.cfg), opt_state_from_numpy(
        params_to_numpy(jo), tm.cfg, "cpu")
    raw, batch = _batch(tm.cfg.vocab, 1)
    jstep = jax.jit(j_build(jm, JAdamW(**OPT), microbatches=mb,
                            fake_quant=fq))
    jp2, jo2, jmet = jstep(jp, jo, j_batch(jm.cfg, raw), jnp.asarray(6))
    tstep = build_train_step(tm, AdamWConfig(**OPT), microbatches=mb,
                             fake_quant=fq)
    to_start = tree_map(torch.clone, to)    # the step updates ``to``
    tp2, to2, tmet = tstep(tp, to, batch, 6)
    # under an activations role a code may flip between the frameworks
    # (test_gradients_match_and_c9_set); bf16 rounds in other places
    rtol = 1e-5 if dtype == "float32" and quant != "weights+activations" \
        else 2e-3
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=rtol, atol=1e-7, err_msg=k)
    want = opt_state_from_numpy(params_to_numpy(jo2), tm.cfg, "cpu")
    _close(to2["master"], want["master"], 2e-3, 2e-5, "master")
    jt = _port(jp2, tm.cfg)
    if dtype == "float32":
        for k in ("m", "v"):
            _close(to2[k], want[k], 2e-3, 2e-5, k)
        _close(tp2, jt, 2e-3, 2e-5, "params")
        return
    for k, b in (("m", 0.9), ("v", 0.95)):
        for (pth, t), (_, w), (_, x) in zip(leaves_with_path(to2[k]),
                                            leaves_with_path(want[k]),
                                            leaves_with_path(to_start[k])):
            gt, gw = (t - b * x) / (1 - b), (w - b * x) / (1 - b)
            assert float((gt - gw).norm()) <= 0.1 * float(gw.norm()), \
                f"{k} {path_key(pth)}"
    for (_, p), (_, w), (_, m) in zip(leaves_with_path(tp2),
                                      leaves_with_path(jt),
                                      leaves_with_path(to2["master"])):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, m.to(torch.bfloat16))
        w = w.float()
        diff = (p.float() - w).abs()
        assert bool((diff <= 2e-5 + 2e-3 * w.abs() + _bf16_step(w)).all())


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("arch", ["chatglm3_6b", "moonshot_v1_16b_a3b"])
def test_gradients_match_and_c9_set(arch, quant):
    """The loss gradient of every param (f32) against ``jax.grad`` of the
    reference's loss on the first batch, within 1e-4 of each leaf's
    largest element; the port's ``None`` leaves are exactly the
    reference's all-zero ones (ROADMAP C9), and under a ``weights`` role
    they include every fake-quantized matmul weight.

    Under an ``activations`` role a quantizer input that lies within the
    two frameworks' rounding noise of an MX rounding boundary takes the
    neighbouring code on one side (measured: a few elements of each
    (8, 32, d) input lie within 2e-6 relative of a boundary), and one such
    flip moves a token's logits and, in an MoE layer, can reroute it.
    Where the two forwards' logits differ by more than 1e-4 at some token,
    the test requires such tokens to be at most 5% of the batch and the
    loss within rtol 2e-3, and holds the C9 set, but not each gradient
    element."""
    fq = quant != "none"
    jm, tm, jp, _ = _pair(arch, "float32", QUANTS[quant])
    raw, batch = _batch(tm.cfg.vocab, 0)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(jm, p, b, fake_quant=fq), has_aux=True))(
        jp, j_batch(jm.cfg, raw))
    tp = _port(jp, tm.cfg)
    tl, _, tg = _grads_of(tm, tp, batch, fq)
    jlog, _ = jm.forward(jp, j_batch(jm.cfg, raw), fake_quant=fq)
    with torch.no_grad():
        tlog, _ = tm.forward(tp, batch, fake_quant=fq)
    apart = int(((tlog - torch.from_numpy(np.asarray(jlog))).abs()
                 .amax(-1) > 1e-4).sum())
    if quant != "weights+activations":
        assert apart == 0
    assert apart <= 0.05 * B * S
    np.testing.assert_allclose(float(tl), float(jl),
                               rtol=1e-5 if apart == 0 else 2e-3)
    jg = _port(jg, tm.cfg, torch.float32)
    none, zero = set(), set()
    for (pt, t), (pj, j) in zip(leaves_with_path(tg), leaves_with_path(jg)):
        key = path_key(pt)
        if not bool(j.abs().max() > 0):
            zero.add(key)
        if t is None:
            none.add(key)
        elif apart == 0:
            np.testing.assert_allclose(
                t.numpy(), j.numpy(), rtol=0,
                atol=1e-4 * float(j.abs().max()), err_msg=key)
    assert none == zero
    matmul = {k for k, _ in map(lambda kv: (path_key(kv[0]), kv[1]),
                                leaves_with_path(tg))
              if k.rsplit("/", 1)[-1] in ("wq", "wk", "wv", "wo", "w1",
                                          "w2", "w3")}
    if fq:
        assert matmul <= none
    else:
        assert not none


def test_forward_under_policy_table_matches_reference():
    """The training forward with ``fake_quant`` under a per-layer
    ``PolicyTable`` (each layer its own weights and activations formats,
    the reference's unrolled ``mx_table`` walk): logits within 1e-4 (the
    forward tolerance of tests/test_torch_model.py), and one train step's
    loss and master within the f32 tolerances above.  (On this batch an
    INT8 activations role flips codes between the frameworks, as
    ``test_gradients_match_and_c9_set`` describes, so the table's
    activation formats are E4M3 and E3M2.)"""
    from repro.core.spec import PolicyTable as JTable
    from repro.models.config import apply_policy_table as j_apply
    from repro_torch.core.spec import PolicyTable as TTable
    from repro_torch.models import apply_policy_table as t_apply
    text = ('{"schema": "policy_table/v1", "default": {"weights": '
            '"e4m3@32:ocp", "activations": "e4m3@32:paper"}, "layers": '
            '{"1": {"weights": "e2m1@32:ocp", "activations": '
            '"e3m2@32:paper"}}}')
    jm, tm, jp, jo = _pair("chatglm3_6b", "float32", "none")
    jm = JModel(j_apply(jm.cfg, JTable.from_json(text)))
    tm = Model(t_apply(tm.cfg, TTable.from_json(text)), "cpu")
    assert tm.cfg.mx_table is not None
    raw, batch = _batch(tm.cfg.vocab, 2)
    jlog, _ = jm.forward(jp, j_batch(jm.cfg, raw), fake_quant=True)
    tlog, _ = tm.forward(_port(jp, tm.cfg), batch, fake_quant=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    # the table steers each layer: its logits are not the default's
    flat = Model(dataclasses.replace(tm.cfg, mx_table=None), "cpu")
    assert not torch.allclose(
        flat.forward(_port(jp, tm.cfg), batch, fake_quant=True)[0], tlog,
        atol=1e-3)
    jo = random_moments(jo)
    jstep = jax.jit(j_build(jm, JAdamW(**OPT), fake_quant=True))
    _, jo2, jmet = jstep(jp, jo, j_batch(jm.cfg, raw), jnp.asarray(6))
    tstep = build_train_step(tm, AdamWConfig(**OPT), fake_quant=True)
    _, to2, tmet = tstep(_port(jp, tm.cfg), opt_state_from_numpy(
        params_to_numpy(jo), tm.cfg, "cpu"), batch, 6)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _close(to2["master"], opt_state_from_numpy(
        params_to_numpy(jo2), tm.cfg, "cpu")["master"], 2e-3, 2e-5,
        "master")


@pytest.mark.parametrize("quant", ["none", "weights"])
def test_twenty_five_steps_loss_curves_match(quant):
    """25 f32 steps of the reference's integration setup (lr 2e-3, warm-up
    5, no weight decay, batches of 8 x 32 from seed 3) from the same
    params: the two loss curves agree within 1e-3 relative at every
    step (the weights drift apart by the rounding noise of each step, so
    later steps are held a little looser than one step's 1e-5)."""
    fq = quant != "none"
    jm, tm, jp, jo = _pair("chatglm3_6b", "float32", QUANTS[quant])
    opt = dict(OPT, weight_decay=0.0)
    jstep = jax.jit(j_build(jm, JAdamW(**opt), fake_quant=fq))
    tstep = build_train_step(tm, AdamWConfig(**opt), fake_quant=fq)
    tp = _port(jp, tm.cfg)
    to = opt_state_from_numpy(params_to_numpy(jo), tm.cfg, "cpu")
    jl, tl = [], []
    for i in range(25):
        raw, batch = _batch(tm.cfg.vocab, i)
        jp, jo, jmet = jstep(jp, jo, j_batch(jm.cfg, raw), jnp.asarray(i))
        tp, to, tmet = tstep(tp, to, batch, i)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0] * (0.8 if quant == "none" else 0.85)


@pytest.mark.parametrize("spec", ["e4m3@32:ocp", "e2m1@32:paper",
                                  "int8@32:ocp", "e3m2@16:ocp"])
def test_fake_quantize_is_the_plain_round_trip(spec):
    """``ops.fake_quantize`` (the QAT route) on the CPU equals the port's
    ``core.convert.quantize_dequantize`` bit for bit along each axis,
    a ragged last block (K 112) and NaN / Inf blocks included, and equals
    the reference's round trip where no scale code is 0 (ROADMAP C1);
    its result carries no gradient (ROADMAP C9)."""
    from repro.core.convert import quantize_dequantize as j_qd
    from repro.core.spec import QuantSpec as JSpec
    from repro_torch.core.convert import quantize_dequantize
    from repro_torch.kernels.ops import fake_quantize
    rng = np.random.default_rng(8)
    x = rng.normal(size=(112, 3, 96)).astype(np.float32)
    x[5, 1, 7], x[60, 2, 3], x[100, 0, 90] = np.nan, np.inf, -np.inf
    t = torch.from_numpy(x).requires_grad_(True)
    for axis in (0, 2, -1):
        got = fake_quantize(t, spec, axis=axis)
        assert got.grad_fn is None and not got.requires_grad
        want = quantize_dequantize(t.detach(), spec, axis=axis)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        ref = np.asarray(j_qd(jnp.asarray(x), JSpec.parse(spec),
                              axis=axis))
        np.testing.assert_array_equal(got.numpy(), ref)
