"""The port's train step on the five families beyond the GQA decoder
(MLA ``deepseek_v2_236b``, the patch frontend ``internvl2_76b``, the
Mamba2 hybrid ``zamba2_1p2b``, RWKV6 ``rwkv6_7b``, the encoder-decoder
``seamless_m4t_medium``) against the JAX package's, on the reduced
configs in f32, from the same params and AdamW state (numpy, carried
across by ``models.params.from_numpy`` / ``opt_state_from_numpy``) and
the same ``SyntheticLM`` batch through each package's ``make_batch_for``
(its frames and patch embeddings included).

The reference's side runs once per (arch, quant, microbatches) through a
module-scoped cache, one jitted call each.  At one microbatch the
reference's step is ``jax.value_and_grad`` of its ``_loss_fn`` and then
``adamw_update`` (src/repro/train/step.py:60-87): the call runs those two
functions (its forward's logits taken on the way), so the gradients the
tests compare are the ones the step applied; at four it runs
``build_train_step``.

Tolerances are ``tests/test_torch_train.py``'s: loss, ``ce``, ``aux``,
``grad_norm`` and ``lr`` within rtol 1e-5; params, ``master``, ``m`` and
``v`` after the step within rtol 2e-3, atol 2e-5; gradients within 1e-4 of
each leaf's largest element.  The recurrent scans need no looser ones
(measured: the hybrid's worst leaf, a Mamba2 ``dt_bias``, at 3.5e-5).

Under weights + activations an activation within the two frameworks'
rounding noise of an MX rounding boundary takes the neighbouring code on
one side (``test_torch_train.py::test_gradients_match_and_c9_set``), and
in these families one flip reaches more tokens than in a decoder: every
later token of its row in the hybrid and RWKV (the recurrence carries
it), every decoder token of its row in the encoder-decoder (the
cross-attention reads every frame; measured on these batches: 3 of 8
rows).  Where the two forwards' logits differ by more than 1e-4 at some
token, the rows that hold such tokens must be at most ``FLIP_ROWS`` of
the batch's 8, the scalars are held within rtol 2e-3, params and
``master`` after the step within the f32 tolerances above, the gradient
each side folded into ``m`` and ``v`` within ``FLIP_GRAD_RTOL`` of the
leaf's norm (measured: up to 3.1e-2, the encoder-decoder's ``norm_f``
and ``lm_head``, the only leaves with a gradient there under C9), and
each gradient element is not compared; the C9 set is held whatever the
flips.  Microbatches 4 run for the two recurrent families with no quant,
where the accumulation is held at the f32 tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import QuantPolicy as JPolicy
from repro.data import DataConfig, SyntheticLM, make_batch_for as j_batch
from repro.models import Model as JModel, load_reduced as j_load_reduced
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_update as j_adamw_update
from repro.train import build_train_step as j_build, init_train_state
from repro.train.step import _loss_fn as j_loss_fn
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.data import make_batch_for
from repro_torch.models import Model, load_reduced
from repro_torch.models.params import from_numpy, opt_state_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.train import build_train_step
from repro_torch.train.step import _grads_of
from repro_torch.tree import leaves_with_path, path_key, tree_map
from torch_parity import LogitsTap, params_to_numpy, random_moments

torch.set_num_threads(1)

ARCHS = ("deepseek_v2_236b", "internvl2_76b", "zamba2_1p2b", "rwkv6_7b",
         "seamless_m4t_medium")
RECURRENT = ("zamba2_1p2b", "rwkv6_7b")
QUANTS = {"none": "none", "weights+activations":
          "weights=e4m3@32:ocp,activations=e4m3@32:ocp"}
CASES = [(a, q, 1) for a in ARCHS for q in QUANTS] + [
    (a, "none", 4) for a in RECURRENT]
OPT = dict(lr=2e-3, warmup_steps=5, total_steps=25)
B, S, STEP = 8, 32, 6
FLIP_ROWS = 3
FLIP_GRAD_RTOL = 5e-2
# the matmul weights each family fake-quantizes (``dense`` with the
# policy): under a weights role none of them gets a gradient (C9)
MATMULS = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3", "w_dq",
                     "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv", "in_proj",
                     "out_proj", "wr", "wg"})


def _models(arch, quant):
    over = dict(dtype="float32", param_dtype="float32", attn_impl="flash")
    jm = JModel(j_load_reduced(arch, mx=JPolicy.parse(quant), **over))
    tm = Model(load_reduced(arch, mx=TPolicy.parse(quant), **over), "cpu")
    return jm, tm


def _raw(vocab):
    return SyntheticLM(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                  seed=3)).batch(1)


@pytest.fixture(scope="module")
def reference():
    """``get(arch, quant, mb)``: the JAX side of one case, computed once
    for the module: params and (random-moment) AdamW state as numpy, the
    forward logits, loss and gradients (``mb`` 1), and the state and
    metrics after one step at ``STEP``.  The params and state depend on
    the arch alone (the policy steers the forward, not the init)."""
    cache, start = {}, {}

    def get(arch, quant, mb):
        key = (arch, quant, mb)
        if key not in cache:
            jm, _ = _models(arch, QUANTS[quant])
            fq = quant != "none"
            if arch not in start:
                # one compiled init (op by op, deepseek's takes 14 s)
                jp, jo = jax.jit(functools.partial(init_train_state, jm))(
                    jax.random.PRNGKey(0))
                start[arch] = jp, random_moments(jo)
            jp, jo = start[arch]
            batch = j_batch(jm.cfg, _raw(jm.cfg.vocab))
            step = j_build(jm, JAdamW(**OPT), microbatches=mb,
                           fake_quant=fq)

            def run(p, o, b, s):
                if mb > 1:
                    return {"step": step(p, o, b, s)}
                tap = LogitsTap(jm)

                def loss(q):
                    value, met = j_loss_fn(tap, q, b, fake_quant=fq)
                    return value, (met, tap.logits)

                (value, (met, logits)), grads = jax.value_and_grad(
                    loss, has_aux=True)(p)
                p2, o2, omet = j_adamw_update(
                    JAdamW(**OPT), grads, o, s, jnp.dtype(jm.cfg.param_dtype))
                return {"step": (p2, o2, {"loss": value, **met, **omet}),
                        "logits": logits, "grad": ((value, met), grads)}

            # the step updates nothing in place: jp and jo stay valid
            out = jax.jit(run)(jp, jo, batch, jnp.asarray(STEP))
            cache[key] = jax.tree_util.tree_map(
                np.asarray, {"params": params_to_numpy(jp),
                             "opt": params_to_numpy(jo), **out})
        return cache[key]

    return get


def _close(got, want, rtol, atol, what):
    for (pg, g), (pw, w) in zip(leaves_with_path(got),
                                leaves_with_path(want)):
        assert pg == pw, (pg, pw)
        np.testing.assert_allclose(
            g.to(torch.float32).numpy(), w.to(torch.float32).numpy(),
            rtol=rtol, atol=atol, err_msg=f"{what} {path_key(pg)}")


def _apart_rows(tm, params, batch, want_logits, fq) -> int:
    with torch.no_grad():
        logits, _ = tm.forward(params, batch, fake_quant=fq)
    d = (logits - torch.from_numpy(want_logits)).abs().amax(-1)
    return int((d > 1e-4).any(-1).sum())


@pytest.mark.parametrize("arch,quant,mb", CASES)
def test_train_step_matches_reference(reference, arch, quant, mb):
    """One ``build_train_step`` step at step 6 (past warm-up) from the
    reference's params and random moments: metrics, params and AdamW
    state after it (tolerances in the module docstring)."""
    fq = quant != "none"
    ref = reference(arch, quant, mb)
    _, tm = _models(arch, QUANTS[quant])
    tp = from_numpy(ref["params"], tm.cfg, "cpu")
    to = opt_state_from_numpy(ref["opt"], tm.cfg, "cpu")
    batch = make_batch_for(tm.cfg, _raw(tm.cfg.vocab), device="cpu")
    apart = _apart_rows(tm, tp, batch, reference(arch, quant, 1)["logits"],
                        fq)
    if not fq:
        assert apart == 0
    assert apart <= FLIP_ROWS
    tstep = build_train_step(tm, AdamWConfig(**OPT), microbatches=mb,
                             fake_quant=fq)
    tp2, to2, tmet = tstep(tp, to, batch, STEP)
    jp2, jo2, jmet = ref["step"]
    rtol = 1e-5 if apart == 0 else 2e-3
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=rtol, atol=1e-7, err_msg=k)
    want = opt_state_from_numpy(jo2, tm.cfg, "cpu")
    _close(to2["master"], want["master"], 2e-3, 2e-5, "master")
    _close(tp2, from_numpy(jp2, tm.cfg, "cpu"), 2e-3, 2e-5, "params")
    if apart == 0:
        for k in ("m", "v"):
            _close(to2[k], want[k], 2e-3, 2e-5, k)
        return
    # flipped rows move the gradient of the leaves outside the layers (the
    # only ones with a gradient under C9): hold the gradient each side
    # folded into m and v ((m' - b1 m) / (1 - b1), and its square from v)
    # within FLIP_GRAD_RTOL of the leaf's norm
    for k, b in (("m", 0.9), ("v", 0.95)):
        for (pth, t), (_, w), (_, x) in zip(
                leaves_with_path(to2[k]), leaves_with_path(want[k]),
                leaves_with_path(opt_state_from_numpy(ref["opt"], tm.cfg,
                                                      "cpu")[k])):
            gt, gw = (t - b * x) / (1 - b), (w - b * x) / (1 - b)
            err = float((gt - gw).norm()) / max(float(gw.norm()), 1e-30)
            assert err <= FLIP_GRAD_RTOL, f"{k} {path_key(pth)}: {err}"


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_and_c9_set(reference, arch, quant):
    """The loss gradient of every param against ``jax.grad`` of the
    reference's loss, within 1e-4 of each leaf's largest element (not
    elementwise where a code flip moved some row: module docstring); the
    port's ``None`` leaves are exactly the reference's all-zero ones
    (ROADMAP C9), and under a weights role they include every
    fake-quantized matmul weight, the hybrid's shared block and the
    encoder's layers among them."""
    fq = quant != "none"
    ref = reference(arch, quant, 1)
    _, tm = _models(arch, QUANTS[quant])
    tp = from_numpy(ref["params"], tm.cfg, "cpu")
    batch = make_batch_for(tm.cfg, _raw(tm.cfg.vocab), device="cpu")
    apart = _apart_rows(tm, tp, batch, ref["logits"], fq)
    assert apart <= (FLIP_ROWS if fq else 0)
    tl, _, tg = _grads_of(tm, tp, batch, fq)
    (jl, _), jg = ref["grad"]
    np.testing.assert_allclose(float(tl), float(jl),
                               rtol=1e-5 if apart == 0 else 2e-3)
    jg = from_numpy(jg, tm.cfg, "cpu", dtype=torch.float32)
    none, zero, matmul = set(), set(), set()
    for (pt, t), (_, j) in zip(leaves_with_path(tg), leaves_with_path(jg)):
        key = path_key(pt)
        if key.rsplit("/", 1)[-1] in MATMULS:
            matmul.add(key)
        if not bool(j.abs().max() > 0):
            zero.add(key)
        if t is None:
            none.add(key)
        elif apart == 0:
            np.testing.assert_allclose(
                t.numpy(), j.numpy(), rtol=0,
                atol=1e-4 * float(j.abs().max()), err_msg=key)
    assert none == zero
    if fq:
        assert matmul <= none
    else:
        assert not none


def test_shared_block_gradient_sums_its_sites(monkeypatch):
    """The hybrid's shared block runs at every site with one weight set:
    its gradient is the sum of the gradients each site would get from
    its own copy of the weights (f32, every leaf within 1e-5 of its
    largest element: a sum in another order)."""
    from repro_torch.models import hybrid
    from repro_torch.train.step import _loss_fn
    _, tm = _models("zamba2_1p2b", "none")
    params = tm.init(seed=1)
    batch = make_batch_for(tm.cfg, _raw(tm.cfg.vocab), device="cpu")
    _, _, g = _grads_of(tm, params, batch, False)
    sites = hybrid.n_groups(tm.cfg)
    copies = [tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params["shared_attn"]) for _ in range(sites)]
    calls, shared = iter(copies), hybrid._shared_block
    monkeypatch.setattr(hybrid, "_shared_block",
                        lambda sp, x, cfg, **kw: shared(next(calls), x, cfg,
                                                        **kw))
    loss, _ = _loss_fn(tm, params, batch, fake_quant=False)
    flat = [t for c in copies for _, t in leaves_with_path(c)]
    gs = torch.autograd.grad(loss, flat)
    n = len(flat) // sites
    for i, (path, want) in enumerate(leaves_with_path(g["shared_attn"])):
        got = sum(gs[i + s * n] for s in range(sites))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   err_msg=path_key(path))
