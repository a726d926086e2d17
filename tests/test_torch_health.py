"""The port's numeric-health guards against the reference's goldens
(mirrors tests/test_health_goldens.py), on the CPU.

A prompt whose activations go non-finite (one embedding row poked to Inf
or NaN) must be quarantined at admission with a diagnostic, while a
healthy request sharing the batch streams the tokens the JAX engine
gives it served alone.  Coverage as in the reference: all six MX element
formats x both modes (paper mode sees SCALE_INF markers from Inf blocks,
ocp mode folds Inf into SCALE_NAN), the fp cache (detection rides the
finite-logits flag), mixed roles, and the ``health_checks=False``
counterfactual.  The reference's weights and poisoned row are carried
across byte for byte.  Beyond the goldens: a decode-window quarantine
(scale bytes of a running slot's page overwritten with SCALE_NAN between
windows) with its pages scrubbed, and the poison reduction itself
against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import ALL_FORMATS
from repro.models import Model as JModel
from repro.models import health as JH
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import GenerationConfig as JGen
from repro_torch.core.formats import SCALE_NAN
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import Model as TModel
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.health import slot_scale_poison
from repro_torch.models.params import from_numpy
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import GenerationConfig as TGen
from torch_parity import params_to_numpy

torch.set_num_threads(1)

PAGE = 8
NEW = 6
BAD_TOK = 5          # the embedding row poked non-finite


def _setup(policy: str, bad_val):
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jp["embed"] = jp["embed"].at[BAD_TOK].set(bad_val)
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy))
    tp = from_numpy(params_to_numpy(jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    healthy = rng.integers(BAD_TOK + 1, jcfg.vocab, size=9).astype(np.int32)
    poisoned = healthy.copy()
    poisoned[4] = BAD_TOK
    return jm, jp, TModel(tcfg, device="cpu"), tp, healthy, poisoned


def _engine(model, params, **kw):
    return TEngine(model, params, max_slots=4, page_size=PAGE, max_len=32,
                   sync_every=4, gen=TGen(max_new_tokens=NEW), **kw)


def _jax_solo(jm, jp, prompt):
    """The JAX engine's tokens for ``prompt`` served alone (rid 0); one
    window shape and no health reductions keep its compile time down,
    and neither changes its tokens."""
    eng = JEngine(jm, jp, max_slots=4, page_size=PAGE, max_len=32,
                  sync_every=1, health_checks=False,
                  gen=JGen(max_new_tokens=NEW))
    rid = eng.add_request(prompt, NEW)
    return eng.run()[rid]


def _assert_quarantined(policy, bad_val):
    jm, jp, tm, tp, healthy, poisoned = _setup(policy, bad_val)
    want = _jax_solo(jm, jp, healthy)
    eng = _engine(tm, tp)
    rh = eng.add_request(healthy, NEW)
    rp = eng.add_request(poisoned, NEW)
    out = eng.run()
    failed = {r.rid: r.error for r in eng.scheduler.failed}
    assert set(failed) == {rp}, failed
    assert "health guard" in failed[rp]
    assert eng.n_quarantined == 1 and rp not in out
    # the healthy neighbour is untouched by the quarantine next door
    np.testing.assert_array_equal(out[rh], want)
    assert len(out[rh]) == NEW


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", [f.name for f in ALL_FORMATS])
def test_nonfinite_prompt_quarantined_all_formats(fmt, mode):
    kv = f"{fmt}@32:{mode}"
    _assert_quarantined(f"kv_key={kv},kv_value={kv}",
                        np.inf if mode == "paper" else np.nan)


def test_nonfinite_prompt_quarantined_fp_cache():
    """No scale bytes in a dense cache: detection rides the finite-logits
    flag."""
    _assert_quarantined("none", np.nan)


def test_nonfinite_prompt_quarantined_mixed_roles():
    _assert_quarantined("kv_key=int8@32:paper,kv_value=e2m1@32:ocp",
                        np.nan)


def test_health_off_streams_garbage():
    """With ``health_checks=False`` the poisoned request is not
    quarantined: it streams its whole budget; the healthy row still has
    the JAX engine's tokens."""
    jm, jp, tm, tp, healthy, poisoned = _setup(
        "kv_key=int8@32:paper,kv_value=e4m3@32:paper", np.nan)
    want = _jax_solo(jm, jp, healthy)
    eng = _engine(tm, tp, health_checks=False)
    rh = eng.add_request(healthy, NEW)
    rp = eng.add_request(poisoned, NEW)
    out = eng.run()
    assert not eng.scheduler.failed and eng.n_quarantined == 0
    assert len(out[rp]) == NEW
    np.testing.assert_array_equal(out[rh], want)


def test_decode_window_quarantine_scrubs_pages():
    """A running slot whose live KV scale bytes turn into SCALE_NAN
    markers between windows is quarantined at the next window boundary
    (attention reads the marker, so its logits go non-finite; the poison
    scan flags it as well), its pages are zeroed before they can recycle,
    and its neighbour keeps the tokens it gets alone."""
    policy = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
    cfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy),
                         attn_impl="flash")
    tm = TModel(cfg, device="cpu")
    tp = tm.init(seed=0, quantize=True)
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, cfg.vocab, size=n).astype(np.int32)
            for n in (7, 12))
    solo = _engine(tm, tp)
    ra = solo.add_request(a, 12)
    want = solo.run()[ra]
    eng = _engine(tm, tp)
    ra, rb = eng.add_request(a, 12), eng.add_request(b, 12)
    eng.step()                           # admission and a first window
    req_b = next(r for r in eng.scheduler.running.values() if r.rid == rb)
    pages = eng.blocks.slot_page_ids(req_b.slot)
    eng.pool["vs_pages"][1, pages[0], 3] = SCALE_NAN   # layer 1, pos 3
    emitted = eng.step()                 # the next window trips the guard
    assert [r.rid for r in eng.scheduler.failed] == [rb]
    assert rb not in {rid for rid, _ in emitted}
    assert "numeric-health guard" in eng.scheduler.failed[0].error
    for leaf in eng.pool.values():       # scrubbed before any reuse
        assert not leaf[:, pages].any()
    out = eng.run()
    assert eng.n_quarantined == 1 and rb not in out
    np.testing.assert_array_equal(out[ra], want)


@pytest.mark.parametrize("policy", [
    "kv_key=int8@32:paper,kv_value=e2m1@32:ocp", "kv=e3m2@32:ocp"])
def test_slot_scale_poison_matches_reference(policy):
    """The poison reduction against the reference's on the same pool
    bytes: markers inside and past each slot's length, on the trash page
    and in both roles."""
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy))
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy))
    tpool = TModel(tcfg, device="cpu").init_paged_cache(12, PAGE)
    rng = np.random.default_rng(2)
    raw = {}
    for k, leaf in tpool.items():
        x = rng.integers(0, 250, size=tuple(leaf.shape)).astype(np.uint8)
        if k in ("ks_pages", "vs_pages"):
            spec = tcfg.mx.kv_key if k == "ks_pages" else tcfg.mx.kv_value
            mark = 0xFE if spec.mode == "paper" else 0xFF
            hits = rng.random(x.shape[:-1]) < 0.01
            x[..., 0][hits] = mark
        raw[k] = x
        leaf.copy_(torch.from_numpy(x))
    jpool = {"layers": {k: jnp.asarray(v) for k, v in raw.items()}}
    tables = rng.integers(0, 12, size=(5, 3)).astype(np.int32)
    lengths = np.array([0, 3, 8, 17, 24], np.int32)
    want = np.asarray(JH.slot_scale_poison(
        jpool, jnp.asarray(tables), jnp.asarray(lengths), jcfg))
    got = slot_scale_poison(tpool, torch.from_numpy(tables),
                            torch.from_numpy(lengths), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
