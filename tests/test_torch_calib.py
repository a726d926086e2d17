"""The port's calibration (``repro_torch.calib``) against the JAX
package's (mirrors tests/test_calib.py).

The cases of the reference's file run on the port's own stats of the
reduced chatglm3-6b (3 layers, f32, the reference's weights carried
across).  Beyond them, on the same inputs from a numpy seed:

* ``tensor_reduction`` of the JAX taps (as numpy) equals the JAX one:
  ``count``, ``n_zero``, ``exp_hist`` and ``sample`` exactly, the moments
  within 1e-6 relative (f32 sums in another order);
* ``forward_calib``'s logits and taps within the forward tolerance of
  tests/test_torch_model.py (1e-4);
* given the JAX package's ``CalibStats``, the port's searches emit the
  same ``PolicyTable`` JSON (and its own stats do too);
* the sweep's scores equal the JAX package's within 1e-4 dB where no
  scale code of the sample is 0 (ROADMAP C1: XLA on the CPU flushes the
  2^-127 scale that the port keeps);
* the ``grads`` role through ``flash_attention_vjp`` (attention at
  ``"flash"``) equals plain autograd through dense attention.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.calib import (collect_model_stats, parse_auto_budget,
                               score_sample, search_kv_policy,
                               search_weights_policy, sweep_role,
                               weight_param_nbytes)
from repro_torch.calib.stats import TensorStats, _to_stats, tensor_reduction
from repro_torch.core import QuantPolicy, QuantSpec
from repro_torch.core.convert import mx_quantize
from repro_torch.models import Model, apply_policy_table, load_reduced
from repro_torch.serve.paging import (kv_cache_token_nbytes, kv_token_nbytes,
                                      spec_side_nbytes)

torch.set_num_threads(1)

N_LAYERS = 3
ALL = ("kv_key", "kv_value", "activations", "weights", "grads")
TAP_TOL = 1e-4


def _red(x, **kw):
    return _to_stats(tensor_reduction(torch.from_numpy(np.array(x)), **kw))


@pytest.fixture(scope="module")
def calib_setup():
    """The JAX model, params and stats, and the port's on the same
    weights and batches."""
    import jax
    from repro.calib import collect_model_stats as j_collect
    from repro.models import Model as JModel
    from repro.models import load_reduced as j_load_reduced
    from repro_torch.models.params import from_numpy
    from torch_parity import params_to_numpy
    jcfg = j_load_reduced("chatglm3_6b", n_layers=N_LAYERS)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = load_reduced("chatglm3_6b", n_layers=N_LAYERS)
    model = Model(cfg, device="cpu")
    params = from_numpy(params_to_numpy(jp), cfg, "cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab, size=(2, 32)).astype(np.int32)
               for _ in range(2)]
    stats = collect_model_stats(model, params, batches, roles=ALL)
    jstats = j_collect(jm, jp, batches, roles=ALL)
    return cfg, model, params, stats, (jcfg, jm, jp, jstats, batches)


# =============================================================================
# TensorStats streaming semantics
# =============================================================================
def test_streaming_merge_equals_one_shot():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(48, 32)).astype(np.float32) * 3.0
    one = _red(np.concatenate([a, b]), sample_rows=1 << 20)
    strm = TensorStats()
    strm.merge(_red(a, sample_rows=1 << 20), sample_rows=1 << 20)
    strm.merge(_red(b, sample_rows=1 << 20), sample_rows=1 << 20)
    assert strm.count == one.count == a.size + b.size
    np.testing.assert_allclose(strm.absmax, one.absmax)
    np.testing.assert_allclose(strm.total, one.total, rtol=1e-5)
    np.testing.assert_allclose(strm.sumsq, one.sumsq, rtol=1e-5)
    np.testing.assert_array_equal(strm.exp_hist, one.exp_hist)
    np.testing.assert_array_equal(strm.sample, one.sample)


def test_reduction_counts_zeros_and_exponents():
    ts = _red(np.array([[0.0, 1.0, 2.0, -2.0]], np.float32), block=4)
    assert ts.count == 4 and ts.n_zero == 1
    assert ts.absmax == 2.0
    assert ts.exp_hist[127] == 1           # 1.0
    assert ts.exp_hist[128] == 2           # +/-2.0
    assert ts.exp_hist.sum() == 3          # zeros excluded
    assert ts.exp_percentile(1.0) == 128


def test_sample_rows_capped():
    ts = _red(np.ones((100, 32), np.float32), sample_rows=8)
    assert ts.sample.shape == (8, 32)
    assert ts.count == 100 * 32            # moments still see everything


@pytest.mark.parametrize("shape, block, scale", [
    ((2, 16, 2, 32), 32, 1.0),             # a KV tap
    ((3, 40), 32, 1e-3),                   # padded to a block multiple
    ((5, 7, 48), 32, 1e30),                # padding, huge exponents
    ((64, 32), 16, 1e-38),                 # subnormals in bin 0
], ids=["kv-tap", "padded", "huge", "subnormal"])
def test_reduction_matches_jax(shape, block, scale):
    """The port's reduction of a tensor equals the JAX one: counts,
    histogram and sample exactly, moments within 1e-6 relative; the
    padding's zeros count in ``count`` and ``n_zero``.  Subnormal values
    keep their exponent bin 0 on both sides, but XLA on the CPU flushes
    them in arithmetic (ROADMAP C1), so their moments are held only to
    the port's own f64 sums."""
    import jax
    from repro.calib.stats import _to_stats as j_to_stats
    from repro.calib.stats import tensor_reduction as j_reduction
    rng = np.random.default_rng(7)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x.reshape(-1)[::11] = 0.0
    want = j_to_stats(jax.device_get(j_reduction(x, block=block,
                                                 sample_rows=64)))
    got = _red(x, block=block, sample_rows=64)
    assert (got.count, got.n_zero) == (want.count, want.n_zero)
    np.testing.assert_array_equal(got.exp_hist, want.exp_hist)
    np.testing.assert_array_equal(got.sample, want.sample)
    ref = want
    if scale < 1e-37:                      # C1: hold to exact sums
        x64 = x.astype(np.float64)
        ref = TensorStats(absmax=np.abs(x64).max(), total=x64.sum(),
                          sumsq=(x.astype(np.float32) ** 2).astype(
                              np.float64).sum())
        assert want.exp_hist[0] == got.exp_hist[0] > 0
    for key in ("absmax", "total", "sumsq"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=1e-6, err_msg=key)


def test_reduction_of_jax_taps_matches_jax(calib_setup):
    """The JAX forward's own taps, reduced by both packages."""
    import jax
    import jax.numpy as jnp
    from repro.calib.stats import _to_stats as j_to_stats
    from repro.calib.stats import tensor_reduction as j_reduction
    *_, (jcfg, jm, jp, _, batches) = calib_setup
    _, _, taps = jm.forward_calib(jp, {"tokens": jnp.asarray(batches[0])})
    for role in ("activations", "kv_key", "kv_value"):
        for t in taps[role]:
            x = np.asarray(t)
            want = j_to_stats(jax.device_get(j_reduction(x)))
            got = _red(x)
            assert (got.count, got.n_zero) == (want.count, want.n_zero)
            np.testing.assert_array_equal(got.exp_hist, want.exp_hist)
            np.testing.assert_array_equal(got.sample, want.sample)
            for key in ("absmax", "total", "sumsq"):
                np.testing.assert_allclose(getattr(got, key),
                                           getattr(want, key), rtol=1e-6,
                                           err_msg=f"{role} {key}")


def test_forward_calib_matches_jax(calib_setup):
    import jax.numpy as jnp
    cfg, model, params, _, (jcfg, jm, jp, _, batches) = calib_setup
    jlog, jaux, jtaps = jm.forward_calib(jp,
                                         {"tokens": jnp.asarray(batches[0])})
    with torch.no_grad():
        log, aux, taps = model.forward_calib(params,
                                             torch.from_numpy(batches[0]))
    np.testing.assert_allclose(log[..., :cfg.vocab].numpy(),
                               np.asarray(jlog)[..., :cfg.vocab],
                               atol=TAP_TOL, rtol=0)
    assert float(aux) == float(jaux) == 0.0
    for role in ("activations", "kv_key", "kv_value"):
        assert len(taps[role]) == N_LAYERS
        for got, want in zip(taps[role], jtaps[role]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TAP_TOL, rtol=TAP_TOL)


def test_collect_matches_jax_stats(calib_setup):
    """Every role and layer of the port's collection against the JAX
    package's: counts exact; forward roles' and weights' histograms
    exact (grads within 1e-3 x count in L1); moments within 1e-4."""
    *_, stats, (_, _, _, jstats, _) = calib_setup
    for role in ALL:
        for layer in range(N_LAYERS):
            got = stats.role_layers(role)[layer]
            want = jstats.role_layers(role)[layer]
            assert (got.count, got.n_zero) == (want.count, want.n_zero)
            l1 = np.abs(got.exp_hist - want.exp_hist).sum()
            assert l1 <= (1e-3 * got.count if role == "grads" else 0), \
                (role, layer, l1)
            for key in ("absmax", "total", "sumsq"):
                np.testing.assert_allclose(getattr(got, key),
                                           getattr(want, key), rtol=1e-4,
                                           err_msg=f"{role} {layer} {key}")


# =============================================================================
# collection over the model
# =============================================================================
def test_collect_covers_all_roles_and_layers(calib_setup):
    _, _, _, stats, _ = calib_setup
    assert stats.n_layers == N_LAYERS and stats.n_batches == 2
    for role in ALL:
        layers = stats.role_layers(role)
        assert sorted(layers) == list(range(N_LAYERS)), role
        for ts in layers.values():
            assert ts.count > 0 and ts.sample is not None
            assert ts.sample.shape[1] == 32          # block rows
            assert np.isfinite(ts.rms) and ts.absmax > 0


def test_collect_unknown_role_rejected(calib_setup):
    _, model, params, _, _ = calib_setup
    with pytest.raises(ValueError, match="unknown tensor role"):
        collect_model_stats(model, params, [], roles=("bogus",))
    weights_only = collect_model_stats(model, params, [],
                                       roles=("weights",))
    with pytest.raises(KeyError, match="not collected"):
        weights_only.role_layers("kv_key")


def test_grads_through_flash_vjp_equal_plain_autograd(calib_setup):
    """At ``attn_impl="flash"`` the prompt attends through
    ``flash_attention_vjp`` (backward by dense recompute); its gradients
    equal plain autograd through dense attention."""
    cfg, model, params, _, (_, _, _, _, batches) = calib_setup
    flash = Model(dataclasses.replace(cfg, attn_impl="flash"), device="cpu")
    kw = dict(roles=("grads",), sample_rows=1 << 20)
    dense = collect_model_stats(model, params, batches[:1], **kw)
    fl = collect_model_stats(flash, params, batches[:1], **kw)
    for layer in range(N_LAYERS):
        a, b = (s.role_layers("grads")[layer] for s in (fl, dense))
        assert a.count == b.count
        np.testing.assert_allclose(a.sample, b.sample, rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(a.sumsq, b.sumsq, rtol=1e-5)


def test_weights_role_needs_fp_params(calib_setup):
    cfg, _, params, _, _ = calib_setup
    qcfg = load_reduced("chatglm3_6b", n_layers=N_LAYERS,
                        mx=QuantPolicy.parse("weights=e4m3@32:ocp"))
    qmodel = Model(qcfg, device="cpu")
    with pytest.raises(ValueError, match="MXWeight"):
        collect_model_stats(qmodel, qmodel.quantize_weights(params), [],
                            roles=("weights",))


# =============================================================================
# sweep
# =============================================================================
def test_sweep_orders_by_quality_and_prices_by_spec(calib_setup):
    cfg, _, _, stats, _ = calib_setup
    cost = lambda s: float(spec_side_nbytes(s, cfg.n_kv_heads, cfg.hd))
    for layer, scored in sweep_role(stats, "kv_key", cost).items():
        sq = [s.sqnr_db for s in scored]
        assert sq == sorted(sq, reverse=True)
        by_fmt = {s.spec.fmt: s for s in scored}
        assert by_fmt["int8"].sqnr_db > by_fmt["e4m3"].sqnr_db
        assert by_fmt["e4m3"].sqnr_db > by_fmt["e2m1"].sqnr_db
        assert by_fmt["int8"].nbytes == by_fmt["e4m3"].nbytes
        assert by_fmt["e2m1"].nbytes < by_fmt["int8"].nbytes


def test_score_sample_exact_signal():
    x = np.tile([1.0, 0.5, 2.0, 4.0], 8).astype(np.float32)[None, :]
    q = score_sample(x, QuantSpec("e4m3", "ocp", 32))
    assert q["sqnr_db"] > 100 and q["max_rel_err"] == 0.0


@pytest.mark.parametrize("role", ["kv_key", "activations", "weights"])
def test_sweep_scores_match_jax(calib_setup, role):
    """Scores of the JAX package's samples, where no scale code is 0."""
    from repro.calib import score_sample as j_score
    from repro.calib.sweep import DEFAULT_CANDIDATES as J_CANDIDATES
    *_, (_, _, _, jstats, _) = calib_setup
    for layer, ts in jstats.role_layers(role).items():
        for jspec in J_CANDIDATES:
            spec = QuantSpec.parse(str(jspec))
            mx = mx_quantize(torch.from_numpy(np.array(ts.sample)), spec)
            assert int(mx.scales.min()) > 0     # away from C1
            got, want = score_sample(ts.sample, spec), j_score(ts.sample,
                                                               jspec)
            np.testing.assert_allclose(got["sqnr_db"], want["sqnr_db"],
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(got["max_rel_err"],
                                       want["max_rel_err"], rtol=1e-6)


# =============================================================================
# budget-constrained search
# =============================================================================
def _kv8_bytes(cfg):
    return kv_token_nbytes(QuantPolicy.parse("kv=int8@32:ocp"),
                           cfg.n_kv_heads, cfg.hd) * N_LAYERS


def test_search_respects_budget_and_improves_with_bytes(calib_setup):
    cfg, _, _, stats, _ = calib_setup
    full = _kv8_bytes(cfg)
    rich = search_kv_policy(stats, full, cfg)
    tight = search_kv_policy(stats, full * 0.7, cfg)
    assert rich.total_nbytes <= full
    assert tight.total_nbytes <= full * 0.7
    assert rich.mean_sqnr_db >= tight.mean_sqnr_db
    assert all(s.spec.fmt == "int8" for s in rich.chosen.values())


def test_search_applied_cost_matches_accounting(calib_setup):
    cfg, _, _, stats, _ = calib_setup
    budget = 0.7 * _kv8_bytes(cfg)
    res = search_kv_policy(stats, budget, cfg)
    cfg2 = apply_policy_table(cfg, res.table)
    assert kv_cache_token_nbytes(cfg2) == int(res.total_nbytes)
    assert kv_cache_token_nbytes(cfg2) <= budget
    assert cfg2.mx_table is not None          # the layers differ


def test_search_infeasible_budget_raises(calib_setup):
    cfg, _, _, stats, _ = calib_setup
    with pytest.raises(ValueError, match="infeasible"):
        search_kv_policy(stats, 1.0, cfg)


def test_search_weights_budget(calib_setup):
    cfg, _, _, stats, _ = calib_setup
    res = search_weights_policy(stats, 0.75, cfg)
    assert res.total_params > 0
    assert res.total_nbytes / res.total_params <= 0.75
    for (role, layer), s in res.chosen.items():
        assert role == "weights"
        np.testing.assert_allclose(
            s.nbytes, weight_param_nbytes(s.spec)
            * stats.role_layers("weights")[layer].count)
        assert s.spec.fmt != "int8" \
            or res.total_nbytes < 1.031 * res.total_params
    assert "B/param" in res.describe()


@pytest.mark.parametrize("ratio", [1.0, 0.85, 0.7, 0.55])
def test_kv_search_on_jax_stats_emits_jax_table(calib_setup, ratio):
    """Given the JAX package's stats, the port's KV search emits the JAX
    search's PolicyTable JSON; so does the port on its own stats."""
    from repro.calib import search_kv_policy as j_search
    cfg, _, _, stats, (jcfg, _, _, jstats, _) = calib_setup
    budget = ratio * _kv8_bytes(cfg)
    want = j_search(jstats, budget, jcfg)
    got = search_kv_policy(jstats, budget, cfg)
    assert got.table.to_json() == want.table.to_json()
    assert got.total_nbytes == want.total_nbytes
    assert search_kv_policy(stats, budget, cfg).table.to_json() \
        == want.table.to_json()


@pytest.mark.parametrize("budget", [1.1, 0.9, 0.75, 0.6])
def test_weights_search_on_jax_stats_emits_jax_table(calib_setup, budget):
    from repro.calib import search_weights_policy as j_search
    cfg, _, _, stats, (jcfg, _, _, jstats, _) = calib_setup
    want = j_search(jstats, budget, jcfg)
    got = search_weights_policy(jstats, budget, cfg)
    assert got.table.to_json() == want.table.to_json()
    assert got.total_params == want.total_params
    assert search_weights_policy(stats, budget, cfg).table.to_json() \
        == want.table.to_json()


# =============================================================================
# budget grammar
# =============================================================================
def test_parse_auto_budget():
    assert parse_auto_budget("auto:96") == 96.0
    assert parse_auto_budget("auto:1.5") == 1.5
    for bad in ("auto", "auto:", "auto:x", "auto:-3", "auto:0"):
        with pytest.raises(ValueError):
            parse_auto_budget(bad)
    for not_auto in ("kv=int8", "autos:12", "automatic:5"):
        with pytest.raises(ValueError, match="not an auto"):
            parse_auto_budget(not_auto)
