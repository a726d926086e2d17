"""The port's optimizer and loss (``repro_torch.optim``,
``train.step.cross_entropy``) against the JAX package's, on the same
numpy inputs.

Tolerances: the schedules' lr within 1 f32 ulp (rtol 1e-6: ``cos`` and
``pow`` of two libraries); ``adamw_update`` (f32 throughout) within rtol
1e-6, atol 1e-9 for ``master``, ``m`` and ``v`` (the same operations in
the same order; the bias corrections' ``pow`` may differ by an ulp) and
the global norm within rtol 1e-6 (sums in another order);
``cross_entropy`` within rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw as jadamw
from repro.train.step import cross_entropy as j_ce
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm, wsd_schedule)
from repro_torch.optim.adamw import _lr
from repro_torch.train import cross_entropy

torch.set_num_threads(1)

SCHEDULES = ("cosine", "wsd", "const")
SHAPES = {"a": (7, 33), "b": {"c": (64,), "d": (3, 5, 8)}, "e": (1,)}


def _tree(shapes, rng, f):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, f) for k, v in shapes.items()}
    return f(rng, shapes)


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _th(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match(schedule):
    """lr at every step of warm-up, the plateau / decay and past the end."""
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=50, schedule=schedule)
    for step in range(0, 60):
        want = float(jadamw._lr(JAdamW(**cfg), jnp.asarray(step)))
        np.testing.assert_allclose(float(_lr(AdamWConfig(**cfg), step)),
                                   want, rtol=1e-6, atol=0)
    assert float(cosine_schedule(AdamWConfig(**cfg), 0)) == 0.0
    np.testing.assert_allclose(
        float(wsd_schedule(AdamWConfig(**cfg), 30, decay_frac=0.5)),
        float(jadamw.wsd_schedule(JAdamW(**cfg), jnp.asarray(30),
                                  decay_frac=0.5)), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e-2])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_adamw_update_matches(schedule, clip):
    """Two updates of a random tree (random moments, bf16 params) at
    steps 9 and 10, with ``clip`` 1e-2 a clipped step (the grad norm is
    ~10); leaf ``e`` has no gradient (``None`` here, zeros there: ROADMAP
    C9).  The state and params are written in place."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, schedule=schedule,
               clip_norm=clip)
    params = _tree(SHAPES, rng, lambda r, s: r.normal(size=s).astype(
        np.float32))
    state = {"master": params,
             "m": _tree(SHAPES, rng, lambda r, s: r.normal(size=s).astype(
                 np.float32) * 0.1),
             "v": _tree(SHAPES, rng, lambda r, s: np.abs(r.normal(
                 size=s)).astype(np.float32) * 0.01)}
    jstate = _jx(state)
    tstate = _th(jax.tree_util.tree_map(np.copy, state))
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
    for step in (9, 10):
        grads = _tree(SHAPES, rng, lambda r, s: r.normal(size=s).astype(
            np.float32))
        grads["e"] = np.zeros(SHAPES["e"], np.float32)
        jp, jstate, jm = jadamw.adamw_update(
            JAdamW(**cfg), _jx(grads), jstate, jnp.asarray(step),
            jnp.bfloat16)
        tg = _th(grads)
        tg["e"] = None
        tp, tstate2, tm = adamw_update(AdamWConfig(**cfg), tg, tstate, step,
                                       torch.bfloat16, tparams)
        assert tp is tparams and tstate2 is tstate
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["grad_norm"]) > 5 * clip or clip == 1.0
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for k in ("master", "m", "v"):
            for a, b in zip(jax.tree_util.tree_leaves(tstate[k]),
                            jax.tree_util.tree_leaves(jstate[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9, err_msg=k)
        for a, b, m in zip(jax.tree_util.tree_leaves(tp),
                           jax.tree_util.tree_leaves(jp),
                           jax.tree_util.tree_leaves(tstate["master"])):
            assert a.dtype == torch.bfloat16
            assert torch.equal(a, m.to(torch.bfloat16))
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=2 ** -7, atol=0)


def test_no_gradient_leaf_decays_only():
    """A leaf with no gradient: its moments decay (here from 0: stay 0)
    and its master takes the weight decay alone, bit for bit."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    p = {"w": torch.randn(4, 4), "u": torch.randn(3)}
    st = adamw_init(p)
    start = p["w"].clone()
    new_p, new_st, met = adamw_update(cfg, {"w": None, "u": torch.ones(3)},
                                      st, 5, torch.float32, p)
    lr = float(met["lr"])
    want = start - lr * (0.0 + 0.1 * start)
    assert torch.equal(new_st["master"]["w"], want)
    assert new_p is p and torch.equal(p["w"], want)
    assert not new_st["m"]["w"].any() and not new_st["v"]["w"].any()
    assert new_st["m"]["u"].all()
    np.testing.assert_allclose(float(met["grad_norm"]), 3 ** 0.5,
                               rtol=1e-6)


def test_adamw_init_and_global_norm():
    """adamw_init: f32 master copies and zero moments of the params'
    structure (a list of layers too); global_norm skips None leaves."""
    p = {"layers": [{"w": torch.ones(2, 3, dtype=torch.bfloat16)}],
         "b": torch.full((4,), 2.0)}
    st = adamw_init(p)
    assert st["master"]["layers"][0]["w"].dtype == torch.float32
    assert st["master"]["b"].data_ptr() != p["b"].data_ptr()
    assert not st["m"]["layers"][0]["w"].any()
    g = {"layers": [{"w": None}], "b": torch.full((4,), 2.0)}
    jg = {"layers": [{"w": jnp.zeros((2, 3))}], "b": jnp.full((4,), 2.0)}
    np.testing.assert_allclose(float(global_norm(g)),
                               float(jadamw.global_norm(jg)), rtol=1e-6)


@pytest.mark.parametrize("vocab,vp", [(500, 512), (512, 512)])
def test_cross_entropy_matches(vocab, vp):
    """Masked (-1) and out-of-vocab labels (>= vocab, a padded column)
    count as invalid; the log-partition runs over every padded column;
    an all-masked batch gives 0 (the denominator clamps at 1)."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 11, vp)).astype(np.float32) * 3
    labels = rng.integers(0, vocab, size=(3, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[1, 2] = vocab
    labels[2, 5] = vp - 1 if vp > vocab else -1
    for lab in (labels, np.full_like(labels, -1)):
        want = float(j_ce(jnp.asarray(logits), jnp.asarray(lab), vocab))
        got = float(cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(lab), vocab))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    want = float(j_ce(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(labels), vocab))
    np.testing.assert_allclose(float(cross_entropy(
        bf, torch.from_numpy(labels), vocab)), want, rtol=1e-6)
