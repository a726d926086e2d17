"""The port's other model families against the JAX package on each
reduced config: MLA (deepseek-v2-236b), the patch frontend
(internvl2-76b), the Mamba2 hybrid (zamba2-1.2b), RWKV6 (rwkv6-7b) and
the encoder-decoder (seamless-m4t-medium).

The reference's params (its ``init``; internvl2's weights also
weight-resident e4m3) are carried across with ``from_numpy``; batches
come from numpy seeds through the same arrays on both sides.  Logits are
held to 1e-4 absolute, the decoder tolerance of tests/test_torch_archs.py
(f32 sums in another order, compounded over the layers); MX codes and
scales bit for bit.  The chunked scans (Mamba2's SSD, RWKV6's WKV) are
held to the step-by-step recurrence and to themselves at another chunk
size with the reference's tolerances (tests/test_ssm_rwkv_oracle.py),
and to the reference's chunked scans.  The reference's Pallas matmul
runs its dequant-einsum path (``REPRO_MX_MATMUL_IMPL=einsum``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import load_config as j_load_config
from repro.models import load_reduced as j_load_reduced
from repro.models import layers as JL
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.config import QuantPolicy as JPolicy
from repro_torch.core.mx_weight import MXWeight as TMXWeight
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import Model as TModel
from repro_torch.models import layers as TL
from repro_torch.models import load_config as t_load_config
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models import make_concrete_batch
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.params import from_numpy
from torch_parity import params_to_numpy

torch.set_num_threads(1)

LOGITS_TOL = 1e-4
FAMILIES = ("deepseek_v2_236b", "internvl2_76b", "zamba2_1p2b", "rwkv6_7b",
            "seamless_m4t_medium")
MX_KV = "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
QAT = "weights=e4m3@32:ocp"
RESIDENT = "weights=e4m3@32:ocp," + MX_KV
# stacked layer trees of the reference, one list each in the port
STACKS = {"decoder": ("layers",), "hybrid": ("blocks",),
          "rwkv": ("blocks",), "encdec": ("enc_layers", "dec_layers")}


@pytest.fixture(autouse=True)
def einsum_matmul(monkeypatch):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")


@functools.lru_cache(maxsize=None)
def _pair(arch, policy="none", resident=False):
    """(JAX model, its params, port model, port params) on the reduced
    config under ``policy``; ``resident`` quantizes the weights."""
    jcfg = j_load_reduced(arch, mx=JPolicy.parse(policy))
    tcfg = t_load_reduced(arch, mx=TPolicy.parse(policy))
    jm = JModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    if resident:
        jp = jax.jit(jm.quantize_weights)(jp)
    return jm, jp, TModel(tcfg, "cpu"), from_numpy(params_to_numpy(jp), tcfg,
                                                   "cpu")


def _batch(cfg, b=2, s=40, seed=0):
    batch = make_concrete_batch(cfg, b, s, seed=seed)
    batch.pop("labels")
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _equal(t, j):
    """A port leaf or subtree equals the reference's, key for key."""
    if isinstance(t, dict):
        return set(t) == set(j) and all(_equal(t[k], j[k]) for k in t)
    if isinstance(t, TMXWeight):
        return (np.array_equal(t.codes.numpy(), np.asarray(j.codes))
                and np.array_equal(t.scales.numpy(), np.asarray(j.scales)))
    return str(t.dtype).split(".")[-1] == np.asarray(j).dtype.name \
        and np.array_equal(t.to(torch.float32).numpy(),
                           np.asarray(j, np.float32))


def _close(t, j, tol=LOGITS_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_and_param_count_match_reference(arch):
    """The published and reduced configs' parameter counts (every
    family's branch), and the reference's ``supports_paged``: false for
    all five."""
    for t, j in ((t_load_config(arch), j_load_config(arch)),
                 (t_load_reduced(arch), j_load_reduced(arch))):
        assert t.param_count() == j.param_count()
        assert not TModel(t, "cpu").supports_paged()
        assert not JModel(j).supports_paged()


@pytest.mark.parametrize("arch", FAMILIES)
def test_from_numpy_carries_the_family_tree(arch):
    """Every stacked tree becomes a list of its layers, each slice equal
    to the reference's (MLA's keys, the hybrid's ``blocks`` and
    ``shared_attn``, RWKV's blocks, the encoder-decoder's ``enc_layers``
    / ``dec_layers`` with ``xattn``); the f32 leaves stay f32."""
    resident = arch == "internvl2_76b"
    jm, jp, tm, tp = _pair(arch, RESIDENT if resident else "none", resident)
    cfg = tm.cfg
    assert set(tp) == set(jp) - {"dense_layers"}
    for key, val in jp.items():
        if key in STACKS[cfg.family]:
            dense = jp.get("dense_layers", []) if key == "layers" else []
            n = len(tp[key])
            for i in range(n):
                j = dense[i] if i < len(dense) else jax.tree_util.tree_map(
                    lambda a: a[i - len(dense)], val)
                assert _equal(tp[key][i], j), (key, i)
        elif key != "dense_layers":
            assert _equal(tp[key], val), key
    if cfg.mla:
        assert {"w_dkv", "w_kr", "w_uk", "w_uv", "w_dq", "w_uq", "q_norm",
                "kv_norm", "wo"} == set(tp["layers"][0]["attn"])
    if cfg.family == "hybrid":
        assert len(tp["blocks"]) == cfg.n_layers
        assert tp["blocks"][0]["a_log"].dtype == torch.float32
    if resident:
        assert isinstance(tp["layers"][0]["attn"]["wq"], TMXWeight)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("policy", ["none", "qat"])
def test_forward_logits_agree(arch, policy):
    """The full forward on the family's batch (frames or patch
    embeddings made from a numpy seed); ``qat`` fake-quantizes the
    weights (e4m3) on both sides."""
    jm, jp, tm, tp = _pair(arch, QAT if policy == "qat" else "none")
    batch = _batch(tm.cfg)
    fq = policy == "qat"
    jlog, _ = jax.jit(functools.partial(jm.forward, fake_quant=fq))(jp, batch)
    tlog, _ = tm.forward(tp, _torch(batch), fake_quant=fq)
    assert tlog.shape == jlog.shape
    _close(tlog, jlog)


def test_resident_weights_forward_agree():
    """internvl2 with weight-resident e4m3 weights (the dequant x matmul
    kernel's plain version against the reference's einsum path)."""
    jm, jp, tm, tp = _pair("internvl2_76b", RESIDENT, True)
    batch = _batch(tm.cfg)
    jlog, _ = jax.jit(jm.forward)(jp, batch)
    tlog, _ = tm.forward(tp, _torch(batch))
    _close(tlog, jlog)


def _cache_leaves(t, j):
    """(port leaf, reference leaf) pairs of two caches of one layout."""
    if isinstance(t, dict):
        for k in t:
            yield from _cache_leaves(t[k], j[k])
    else:
        yield t, j


def _ref_cache(jc, family):
    """The reference's cache in the port's layout: a decoder's dense
    layers and stacked layers as one stack."""
    if family != "decoder":
        return jax.tree_util.tree_map(np.asarray, jc)
    dense = jc.get("dense_layers", [])
    return {k: np.concatenate([np.stack([d[k] for d in dense]), v])
            if dense else np.asarray(v) for k, v in jc["layers"].items()}


def _check_cache(tc, jc, fp: bool = True):
    """fp leaves within 1e-4 (unless ``fp`` is False); MX codes and
    scales equal but where an f32 value sits at a rounding boundary (at
    most 1 byte in 1000)."""
    for t, j in _cache_leaves(tc, jc):
        assert tuple(t.shape) == j.shape
        assert (t.dtype == torch.uint8) == (j.dtype == np.uint8)
        if t.dtype == torch.uint8:
            assert (t.numpy() != j).mean() <= 1e-3
        elif fp:
            np.testing.assert_allclose(t.to(torch.float32).numpy(),
                                       j.astype(np.float32), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kv", ["fp", "mx"])
def test_prefill_then_decode_agree(arch, kv):
    """Prefill, then 4 decode steps fed the reference's greedy tokens:
    the next position equal (the patch frontend's prefix counts), the
    caches / states equal after prefill and at the end (``_check_cache``)
    and the logits within 1e-4 at each step.  Under MX KV a key or value
    at a rounding boundary of its format may take the neighbouring code
    on one side (f32 sums in another order), which moves later logits by
    ~1e-3: there the prefill is held by its cache, and decode starts from
    the reference's cache bytes and states, copied into the port's in
    place (a flipped code moves the states downstream of it too)."""
    policy = MX_KV if kv == "mx" else "none"
    jm, jp, tm, tp = _pair(arch, policy)
    family = tm.cfg.family
    batch = _batch(tm.cfg, s=37)
    # eagerly, as the port runs: under jit XLA fuses the reference's f32
    # ops in another order
    jlog, jc, jpos = jm.prefill(jp, batch, max_len=48)
    tlog, tc, tpos = tm.prefill(tp, _torch(batch), max_len=48)
    assert int(jpos) == tpos
    _check_cache(tc, _ref_cache(jc, family), fp=kv == "fp")
    if kv == "mx":
        for t, j in _cache_leaves(tc, _ref_cache(jc, family)):
            t.copy_(torch.from_numpy(np.array(j)))
    else:
        _close(tlog, jlog)
    vocab = tm.cfg.vocab
    tok = np.argmax(np.asarray(jlog)[:, -1, :vocab], -1).astype(np.int32)
    for i in range(4):
        jlog, jc = jm.decode_step(jp, jnp.asarray(tok), jc,
                                  jnp.asarray(jpos + i, jnp.int32))
        tlog, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, tpos + i)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog)[:, -1, :vocab], -1).astype(np.int32)
    _check_cache(tc, _ref_cache(jc, family))


@pytest.mark.parametrize("pos_kind", ["host", "device"])
def test_mla_cache_write_is_the_plain_converter(pos_kind):
    """MLA's compressed cache under an MX ``kv_key``: the converter's
    codes and scales of c_kv and k_rope, bit for bit the reference's
    ``_kv_quant`` of the same values, at a host or a device position."""
    cfg = t_load_reduced("deepseek_v2_236b",
                         mx=TPolicy.parse("kv=e4m3@32:ocp"))
    rng = np.random.default_rng(5)
    ckv = rng.standard_normal((2, 3, cfg.kv_lora)).astype(np.float32) * 3
    kr = rng.standard_normal((2, 3, cfg.qk_rope_dim)).astype(np.float32)
    ckv[0, 1, :4] = [0.0, np.inf, -np.inf, np.nan]
    cache = TL.init_mla_cache(cfg, 2, 8, "cpu")
    pos = 4 if pos_kind == "host" else torch.tensor([4], dtype=torch.int32)
    TL._mla_cache_write(cache, torch.from_numpy(ckv), torch.from_numpy(kr),
                        pos, cfg)
    spec = JPolicy.parse("kv=e4m3@32:ocp").kv_key
    for name, x in (("ckv", ckv), ("kr", kr)):
        codes, scales = JL._kv_quant(jnp.asarray(x), spec)
        assert np.array_equal(cache[name + "_codes"][:, 4:7].numpy(),
                              np.asarray(codes))
        assert np.array_equal(cache[name + "_scales"][:, 4:7].numpy(),
                              np.asarray(scales))
        assert not cache[name + "_codes"][:, :4].any()


def test_refusals_follow_the_reference():
    """MLA refuses weight-resident storage, calibration taps and paged
    pools; the other families refuse weight-resident storage (the
    reference's messages)."""
    m = TModel(t_load_reduced("deepseek_v2_236b"), "cpu")
    with pytest.raises(NotImplementedError, match="MLA projections"):
        m.init(quantize=True)
    with pytest.raises(NotImplementedError, match="forward_calib"):
        m.forward_calib(m.init(), torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="GQA decoder"):
        m.init_paged_cache(4, 16)
    for arch in ("zamba2_1p2b", "rwkv6_7b", "seamless_m4t_medium"):
        m = TModel(t_load_reduced(arch), "cpu")
        with pytest.raises(NotImplementedError, match="decoder family"):
            m.init(quantize=True)


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_init_matches_the_reference_layout(arch):
    """The port's own seeded init: the reference's tree (shapes and
    dtypes, a stack as a list), in a bf16 config too."""
    for over in ({}, {"dtype": "bfloat16", "param_dtype": "bfloat16"}):
        jcfg = j_load_reduced(arch, **over)
        tcfg = t_load_reduced(arch, **over)
        shapes = jax.eval_shape(lambda: JModel(jcfg).init(
            jax.random.PRNGKey(0)))
        tp = TModel(tcfg, "cpu").init(seed=3)
        want = params_to_numpy(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes))
        got = from_numpy(want, tcfg, "cpu")
        flat_t = jax.tree_util.tree_leaves(tp)
        flat_g = jax.tree_util.tree_leaves(got)
        assert len(flat_t) == len(flat_g)
        for a, b in zip(flat_t, flat_g):
            assert a.shape == b.shape and a.dtype == b.dtype


# ----------------------------------------------------------------------------
# the chunked scans: recurrence oracles, chunk-size invariance, reference
# ----------------------------------------------------------------------------
def _ssd_inputs(seed, b, s, h, p, n, lo, hi):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            -rng.uniform(lo, hi, size=(b, s, h)).astype(np.float32))


def _wkv_inputs(seed, b, s, h, d, hi):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    lw = -rng.uniform(0.01, hi, size=(b, s, h, d)).astype(np.float32)
    return r, k, v, lw, rng.normal(size=(h, d)).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_ssd_chunked_matches_recurrence_and_reference():
    xh, bm, cm, la = _ssd_inputs(0, 2, 48, 3, 8, 4, 0.01, 1.5)
    y, final = tssm._ssd_chunked(*_t(xh, bm, cm, la), chunk=16)
    st = np.zeros((2, 3, 8, 4), np.float64)
    ys = np.zeros((2, 48, 3, 8), np.float64)
    for t in range(48):
        st = st * np.exp(la[:, t].astype(np.float64))[:, :, None, None] \
            + np.einsum("bhp,bn->bhpn", xh[:, t], bm[:, t])
        ys[:, t] = np.einsum("bn,bhpn->bhp", cm[:, t], st)
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), st, rtol=2e-4, atol=2e-4)
    jy, jf = jssm._ssd_chunked(*map(jnp.asarray, (xh, bm, cm, la)), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(final.numpy(), np.asarray(jf), atol=1e-5,
                               rtol=0)


def test_ssd_chunk_size_invariance():
    xs = _t(*_ssd_inputs(2, 1, 64, 2, 4, 4, 0.01, 1.0))
    y1, f1 = tssm._ssd_chunked(*xs, chunk=8)
    y2, f2 = tssm._ssd_chunked(*xs, chunk=32)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=2e-4, atol=2e-4)


def test_wkv_chunked_matches_recurrence_and_reference():
    r, k, v, lw, u = _wkv_inputs(1, 2, 48, 2, 8, 3.0)
    y, final = trwkv._wkv_chunked(*_t(r, k, v, lw, u), chunk=16)
    st = np.zeros((2, 2, 8, 8), np.float64)
    ys = np.zeros((2, 48, 2, 8), np.float64)
    for t in range(48):
        kv = np.einsum("bhd,bhe->bhde", k[:, t], v[:, t]).astype(np.float64)
        ys[:, t] = np.einsum("bhd,bhde->bhe", r[:, t],
                             st + u[None, :, :, None] * kv)
        st = st * np.exp(lw[:, t].astype(np.float64))[..., None] + kv
    np.testing.assert_allclose(y.numpy(), ys, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(final.numpy(), st, rtol=3e-4, atol=3e-4)
    jy, jf = jrwkv._wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=LOGITS_TOL,
                               rtol=0)
    np.testing.assert_allclose(final.numpy(), np.asarray(jf),
                               atol=LOGITS_TOL, rtol=0)


def test_wkv_chunk_size_invariance():
    xs = _t(*_wkv_inputs(3, 1, 64, 2, 8, 2.0))
    y1, f1 = trwkv._wkv_chunked(*xs, chunk=8)
    y2, f2 = trwkv._wkv_chunked(*xs, chunk=16)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_7b"])
def test_prefill_state_equals_the_one_step_recurrence(arch):
    """A prompt prefilled in chunks leaves the state that feeding its
    tokens one at a time through decode leaves, within the scans'
    tolerance, at a whole number of chunks (32 tokens) and past one (37:
    Mamba2 pads with zero log decay, RWKV6 with -1e-5, whose extra decay
    of 1.1e-4 is below this tolerance; see the next test)."""
    jm, jp, tm, tp = _pair(arch)
    for s in (32, 37):
        tokens = _batch(tm.cfg, b=1, s=s, seed=s)["tokens"]
        _, chunked, _ = tm.prefill(tp, torch.from_numpy(tokens), max_len=48)
        _, step, _ = tm.prefill(tp, torch.from_numpy(tokens[:, :1]),
                                max_len=48)
        for i in range(1, s):
            tm.decode_step(tp, torch.from_numpy(tokens[:, i]), step, i)
        if arch == "zamba2_1p2b":
            got, want = chunked["mamba"]["ssm"], step["mamba"]["ssm"]
        else:
            got, want = chunked["tmix_state"], step["tmix_state"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4,
                                   atol=3e-4)


def test_rwkv_padding_decays_the_state(monkeypatch):
    """ROADMAP C11, measured: the reference pads a prompt to a whole
    chunk with log w = -1e-5, not 0, so the time-mix state after a
    37-token prompt is the unpadded scan's times exp(-1e-5 x 11) on
    every entry (the outputs of the real positions are the same); the
    port mirrors it, and its state after prefill equals the
    reference's."""
    jm, jp, tm, tp = _pair("rwkv6_7b")
    cfg = tm.cfg
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 37, cfg.d_model)).astype(np.float32))
    lp = tp["blocks"][0]["tmix"]
    y, (_, padded) = trwkv.rwkv_time_mix(lp, x, cfg)
    monkeypatch.setattr(trwkv, "LOGW_PAD", 0.0)
    y0, (_, exact) = trwkv.rwkv_time_mix(lp, x, cfg)
    assert torch.equal(y, y0)
    decayed = exact * np.exp(-1e-5 * 11)
    # the padded state is the decayed one up to f32 rounding, 20x closer
    # than to the unpadded scan's
    assert (padded - decayed).abs().max() \
        < (padded - exact).abs().max() / 20
    jy, (_, jstate) = jrwkv.rwkv_time_mix(
        jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["tmix"],
        jnp.asarray(x.numpy()), j_load_reduced("rwkv6_7b"))
    np.testing.assert_allclose(padded.numpy(), np.asarray(jstate),
                               atol=1e-5, rtol=1e-5)
