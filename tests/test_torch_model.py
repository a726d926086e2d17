"""The port's reduced chatglm3-6b layers and decoder against the JAX package.

Weights are made by the reference's ``init`` and carried across with
``repro_torch.models.params.from_numpy`` (MXWeight bytes included), so
both sides compute with identical weights.  The reference's
weight-resident matmul runs its dequant-einsum path
(``REPRO_MX_MATMUL_IMPL=einsum``, bit-identical to its fused kernel at
these widths, tests/test_weight_resident.py).  Tolerances: layer
primitives 1e-5, decode-step logits 1e-4 absolute (f32 sums in another
order, compounded over two layers); a KV write with identical inputs
must leave bit-identical pool bytes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import decoder as jdec
from repro.models import layers as JL
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro_torch.core.mx_weight import MXWeight as TMXWeight
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import decoder as tdec
from repro_torch.models import layers as TL
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.params import from_numpy
from torch_parity import params_to_numpy

torch.set_num_threads(1)

POLICY = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
PAGE, NUM_PAGES, SLOTS, NPG = 8, 13, 4, 3


@pytest.fixture
def einsum_matmul(monkeypatch):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")


@functools.lru_cache(maxsize=None)
def _pair(policy=POLICY, attn_impl="dense"):
    """Reference config + params and their port twins (built once per
    policy; the tests only read them).  ``attn_impl="flash"`` sends the
    reference through its Pallas attention kernels (interpret mode)."""
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy),
                          attn_impl=attn_impl)
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if jcfg.mx.weights is not None:
        jp = jax.jit(jm.quantize_weights)(jp)
    tp = from_numpy(params_to_numpy(jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _random_pool(jcfg, seed=0):
    """Layer-stacked page pools filled by the reference converter."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, NUM_PAGES, PAGE, jcfg.n_kv_heads, jcfg.hd)
    out = {}
    for side, spec in (("k", jcfg.mx.kv_key), ("v", jcfg.mx.kv_value)):
        x = rng.normal(size=shape).astype(np.float32)
        codes, scales = JL._kv_quant(jnp.asarray(x), spec)
        if spec.packed:
            codes = JL.pack_codes(codes, spec.fmt)
        out[f"{side}c_pages"] = np.asarray(codes)
        out[f"{side}s_pages"] = np.asarray(scales)
    return out


def _tables():
    bt = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]], np.int32)
    lengths = np.array([20, 11, 3, 0], np.int32)
    return bt, lengths


@pytest.mark.parametrize("wspec", ["e4m3@32:ocp", "e2m1@32:ocp",
                                   "e3m2@32:paper"])
def test_dense_mxweight_matches(einsum_matmul, wspec):
    """``dense`` with an MXWeight (the weight-resident route), packed
    sub-byte storage included."""
    from repro.core.mx_weight import MXWeight as JMXWeight
    from repro.core.spec import QuantSpec as JSpec
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    for k, n in ((128, 128), (128, 64)):
        w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
        jw = JMXWeight.quantize(jnp.asarray(w), JSpec.parse(wspec))
        tw = TMXWeight(codes=torch.from_numpy(np.array(jw.codes)),
                       scales=torch.from_numpy(np.array(jw.scales)),
                       fmt=jw.fmt, mode=jw.mode, block=jw.block,
                       packed=jw.packed, k=jw.k, n=jw.n)
        want = np.asarray(jax.jit(JL.dense)(jnp.asarray(x), jw))
        got = TL.dense(torch.from_numpy(x), tw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-5, atol=1e-5)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    jc, js = JL.rope_tables(jnp.asarray(pos), 32, 10000.0)
    tc, ts = TL.rope_tables(torch.from_numpy(pos), 32, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jc, js, 0.5))
    got = TL.apply_rope(torch.from_numpy(x), tc, ts, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., 16:], x[..., 16:])  # unrotated


@pytest.mark.parametrize("policy", [
    "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp", "kv=e3m2@32:paper",
    "kv=e4m3@32:ocp+unpacked"])
def test_paged_cache_write_bit_identical(policy):
    """Identical k/v in, identical page bytes out (quantize, pack,
    scatter), including the trash-page writes of idle slots."""
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy))
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy))
    pool = {k: v[0] for k, v in _random_pool(jcfg).items()}
    rng = np.random.default_rng(3)
    k = rng.normal(size=(SLOTS, 1, 2, 32)).astype(np.float32)
    v = rng.normal(size=(SLOTS, 1, 2, 32)).astype(np.float32)
    pages = np.array([3, 5, 6, 0], np.int32)
    offsets = np.array([4, 3, 3, 0], np.int32)
    jout = jax.jit(lambda *a: JL.paged_cache_write(*a, jcfg))(
        {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(pages), jnp.asarray(offsets))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    TL.paged_cache_write(tpool, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(pages), torch.from_numpy(offsets),
                         tcfg)
    for name, a in jout.items():
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(a))


def test_attention_paged_decode_matches(einsum_matmul):
    jcfg, tcfg, jp, tp = _pair()
    pool = _random_pool(jcfg)
    bt, lengths = _tables()
    x = np.random.default_rng(4).normal(size=(SLOTS, 1, 128)).astype(
        np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    want, _ = jax.jit(lambda p, x, pool, bt, ln: JL.attention_paged_decode(
        p, x, jcfg, pool=pool, block_tables=bt, lengths=ln))(
        jl["attn"], jnp.asarray(x),
        {n: jnp.asarray(a[0]) for n, a in pool.items()}, jnp.asarray(bt),
        jnp.asarray(lengths))
    got, _ = TL.attention_paged_decode(
        tp["layers"][0]["attn"], torch.from_numpy(x), tcfg,
        pool={n: torch.from_numpy(a[0].copy()) for n, a in pool.items()},
        block_tables=torch.from_numpy(bt), lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_paged_cache_gather_bit_identical():
    """The dequantized slot-major view through the block table (the fp
    path's gather) is bit-identical for identical pool bytes."""
    jcfg, tcfg, _, _ = _pair()
    pool = {k: v[1] for k, v in _random_pool(jcfg).items()}
    bt, _ = _tables()
    jk, jv = JL.paged_cache_gather({n: jnp.asarray(a) for n, a in
                                    pool.items()}, jnp.asarray(bt), jcfg,
                                   jnp.float32, jcfg.hd)
    tk, tv = TL.paged_cache_gather({n: torch.from_numpy(a.copy()) for n, a
                                    in pool.items()}, torch.from_numpy(bt),
                                   tcfg, torch.float32, tcfg.hd)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_fp_kv_paged_decode_matches(einsum_matmul):
    """Without KV roles the pool holds fp pages, written and gathered
    densely (weights still MX-resident)."""
    jcfg, tcfg, jp, tp = _pair("weights=e4m3@32:ocp")
    rng = np.random.default_rng(6)
    pool = {n: rng.normal(size=(NUM_PAGES, PAGE, 2, 32)).astype(np.float32)
            for n in ("k_pages", "v_pages")}
    bt, lengths = _tables()
    x = rng.normal(size=(SLOTS, 1, 128)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    want, jpool = jax.jit(lambda p, x, pool, bt, ln: JL.attention_paged_decode(
        p, x, jcfg, pool=pool, block_tables=bt, lengths=ln))(
        jl["attn"], jnp.asarray(x), {n: jnp.asarray(a) for n, a in
                                     pool.items()}, jnp.asarray(bt),
        jnp.asarray(lengths))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    got, _ = TL.attention_paged_decode(
        tp["layers"][0]["attn"], torch.from_numpy(x), tcfg, pool=tpool,
        block_tables=torch.from_numpy(bt), lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for n in pool:
        np.testing.assert_allclose(tpool[n].numpy(), np.asarray(jpool[n]),
                                   rtol=1e-5, atol=1e-5)


def test_paged_decode_step_logits_match(einsum_matmul):
    jcfg, tcfg, jp, tp = _pair()
    pool = _random_pool(jcfg)
    bt, lengths = _tables()
    tok = np.array([5, 77, 300, 0], np.int32)
    jlog, _ = jax.jit(lambda *a: jdec.paged_decode_step(*a, jcfg))(
        jp, jnp.asarray(tok), {"layers": {n: jnp.asarray(a)
                                          for n, a in pool.items()}},
        jnp.asarray(bt), jnp.asarray(lengths))
    tlog, _ = tdec.paged_decode_step(
        tp, torch.from_numpy(tok),
        {n: torch.from_numpy(a.copy()) for n, a in pool.items()},
        torch.from_numpy(bt), torch.from_numpy(lengths), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)


def test_prefill_logits_match(einsum_matmul):
    jcfg, tcfg, jp, tp = _pair()
    tokens = np.random.default_rng(5).integers(0, 512, size=(2, 16))
    tokens = tokens.astype(np.int32)
    jlog, jcache, _ = jdec.prefill(jp, jnp.asarray(tokens), jcfg, max_len=16)
    tlog, tcache, _ = tdec.prefill(tp, torch.from_numpy(tokens), tcfg,
                                   max_len=16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    assert tcache["k_codes"].shape == jcache["layers"]["k_codes"].shape


def _random_cache(jcfg, b=2, max_len=16, filled=12, seed=7):
    """Layer-stacked contiguous caches whose first ``filled`` positions
    hold random k/v, quantized by the reference's converter under an MX
    policy (the state a prefill leaves)."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, b, max_len, jcfg.n_kv_heads, jcfg.hd)
    out = {}
    for side, spec in (("k", jcfg.mx.kv_key), ("v", jcfg.mx.kv_value)):
        x = rng.normal(size=shape).astype(np.float32)
        x[:, :, filled:] = 0.0
        if spec is None:
            out[side] = x
            continue
        codes, scales = JL._kv_quant(jnp.asarray(x), spec)
        out[f"{side}_codes"] = np.array(codes)
        out[f"{side}_scales"] = np.array(scales)
    return out


@pytest.mark.parametrize("policy", [POLICY, "weights=e4m3@32:ocp"])
def test_decode_step_logits_match(einsum_matmul, policy):
    """Two decode steps over a contiguous cache holding 12 positions:
    through the MX decode kernel under an MX KV policy, densely over an fp
    cache (the reference at attn_impl="flash")."""
    jcfg, tcfg, jp, tp = _pair(policy, "flash")
    cache = _random_cache(jcfg)
    jcache = {"layers": {n: jnp.asarray(a) for n, a in cache.items()}}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    steps = np.random.default_rng(8).integers(0, 512, size=(2, 2))
    steps = steps.astype(np.int32)
    jstep = jax.jit(lambda *a: jdec.decode_step(*a, jcfg))
    for pos in (12, 13):
        jlog, jcache = jstep(jp, jnp.asarray(steps[:, pos - 12]), jcache,
                             jnp.asarray(pos, jnp.int32))
        tlog, tcache = tdec.decode_step(
            tp, torch.from_numpy(steps[:, pos - 12]), tcache, pos, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0)


def test_fp_kv_prefill_logits_match(einsum_matmul):
    """Prefill over an fp cache: the port's flash path (its plain version
    here) against the reference's Pallas flash kernel."""
    jcfg, tcfg, jp, tp = _pair("weights=e4m3@32:ocp", "flash")
    tokens = np.random.default_rng(8).integers(0, 512, size=(2, 20))
    tokens = tokens.astype(np.int32)
    jlog, jcache, _ = jax.jit(lambda p, t: jdec.prefill(p, t, jcfg,
                                                        max_len=24))(
        jp, jnp.asarray(tokens))
    tlog, tcache, _ = tdec.prefill(tp, torch.from_numpy(tokens), tcfg,
                                   max_len=24)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(),
                               np.asarray(jcache["layers"]["k"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        tdec.forward(tp, torch.from_numpy(tokens), tcfg).numpy(),
        np.asarray(jlog), atol=1e-4, rtol=0)


@pytest.mark.parametrize("policy", [
    "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp", "kv=e3m2@32:paper"])
def test_contiguous_cache_write_bit_identical(policy):
    """Identical k/v in, identical contiguous cache bytes out, at a
    position past the start (the decode write)."""
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy))
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy))
    jcache = JL.init_kv_cache(jcfg, 2, 16, 2, 32)
    tcache = TL.init_kv_cache(tcfg, 2, 16, 2, 32, "cpu")
    rng = np.random.default_rng(9)
    jwrite = jax.jit(lambda *a: JL.cache_write(*a, jcfg))
    for pos, s in ((0, 5), (5, 1), (9, 1)):
        k = rng.normal(size=(2, s, 2, 32)).astype(np.float32)
        v = rng.normal(size=(2, s, 2, 32)).astype(np.float32)
        jcache = jwrite(jcache, jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pos, jnp.int32))
        TL.cache_write(tcache, torch.from_numpy(k), torch.from_numpy(v),
                       pos, tcfg)
    for name, a in jcache.items():
        np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(a))
