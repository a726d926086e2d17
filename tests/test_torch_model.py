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
def _pair(policy=POLICY, attn_impl="dense", **overrides):
    """Reference config + params and their port twins (built once per
    policy; the tests only read them).  ``attn_impl="flash"`` sends the
    reference through its Pallas attention kernels (interpret mode) and
    the port through its kernels' wrappers (their plain versions on the
    CPU); ``attn_impl`` and ``overrides`` (e.g. ``head_dim``) apply to
    both configs."""
    jcfg = j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy),
                          attn_impl=attn_impl, **overrides)
    tcfg = t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy),
                          attn_impl=attn_impl, **overrides)
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
    """One layer's paged decode attention over an MX pool at
    ``attn_impl="flash"``: the port's paged decode kernel (its plain
    version here) against the reference's Pallas kernel."""
    jcfg, tcfg, jp, tp = _pair(POLICY, "flash")
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
    """A paged decode step over an MX pool at ``attn_impl="flash"`` (the
    paged decode kernel on both sides)."""
    jcfg, tcfg, jp, tp = _pair(POLICY, "flash")
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
    """Prefill into an MX cache at ``attn_impl="flash"`` (the serving
    setting; a quantized prefill attends its dequantized cache densely on
    both sides)."""
    jcfg, tcfg, jp, tp = _pair(POLICY, "flash")
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


# =============================================================================
# head dims the kernels do not take: the reference goes dense there
# =============================================================================
@pytest.mark.parametrize("hd", [16, 48])
def test_unkernelled_head_dim_decode_logits_match(einsum_matmul, hd):
    """Head dims that are no multiple of 32 (codes padded past D): the
    reference at attn_impl="flash" serves them densely, and so must the
    port, over a contiguous cache and over pages."""
    jcfg, tcfg, jp, tp = _pair(POLICY, "flash", head_dim=hd)
    cache = _random_cache(jcfg)
    jcache = {"layers": {n: jnp.asarray(a) for n, a in cache.items()}}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tok = np.array([5, 77], np.int32)
    jlog, _ = jax.jit(lambda *a: jdec.decode_step(*a, jcfg))(
        jp, jnp.asarray(tok), jcache, jnp.asarray(12, jnp.int32))
    tlog, _ = tdec.decode_step(tp, torch.from_numpy(tok), tcache, 12, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    pool = _random_pool(jcfg)
    bt, lengths = _tables()
    tok = np.array([5, 77, 300, 0], np.int32)
    jlog, jpool = jax.jit(lambda *a: jdec.paged_decode_step(*a, jcfg))(
        jp, jnp.asarray(tok), {"layers": {n: jnp.asarray(a)
                                          for n, a in pool.items()}},
        jnp.asarray(bt), jnp.asarray(lengths))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tlog, _ = tdec.paged_decode_step(
        tp, torch.from_numpy(tok), tpool, torch.from_numpy(bt),
        torch.from_numpy(lengths), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    for n, a in jpool["layers"].items():       # the KV write, bit for bit
        np.testing.assert_array_equal(tpool[n].numpy(), np.asarray(a))


@pytest.mark.parametrize("hd", [16, 48])
def test_unkernelled_head_dim_engines_match_jax(monkeypatch, hd):
    """Greedy tokens of both engines at head dims 16 and 48 (INT8 keys,
    E2M1 values) equal the JAX engines' (reference at attn_impl="flash")."""
    from repro.serve import ContinuousBatchingEngine as JCont
    from repro.serve import GenerationConfig as JGen
    from repro.serve import ServeEngine as JServe
    from repro_torch.models import Model as TModel
    from repro_torch.serve import (ContinuousBatchingEngine, GenerationConfig,
                                   ServeEngine)
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")
    jcfg, tcfg, jp, tp = _pair(POLICY, "flash", head_dim=hd)
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, tcfg.vocab, size=(2, 12)).astype(np.int32)
    want = JServe(jm, jp, max_len=20).generate({"tokens": tokens},
                                               JGen(max_new_tokens=4))
    got = ServeEngine(tm, tp, max_len=20).generate(
        {"tokens": tokens}, GenerationConfig(max_new_tokens=4))
    np.testing.assert_array_equal(got, want)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n in (4, 9, 14)]
    kw = dict(max_slots=2, page_size=PAGE, max_len=14 + 4 + 1)
    outs = []
    for eng in (JCont(jm, jp, sync_every=1, health_checks=False, **kw),
                ContinuousBatchingEngine(tm, tp, **kw)):
        rids = [eng.add_request(p, 4) for p in prompts]
        res = eng.run()
        outs.append([res[r].tolist() for r in rids])
    assert outs[0] == outs[1]


def _ref_ctx_none(fn, *args, kk, kv):
    """Whether a reference dispatch (``*_ctx``) returns None for a layout:
    the cue for its dense path.  Layouts it takes run its Pallas kernel in
    interpret mode."""
    import types
    cfg = types.SimpleNamespace(mx=types.SimpleNamespace(kv_key=kk,
                                                         kv_value=kv))
    return fn(*args, cfg) is None


@pytest.mark.parametrize("d,kv,pad", [
    (32, "int8@32:ocp/e2m1@32:ocp", 0), (64, "e3m2@32:paper/e4m3@32:ocp", 0),
    (16, "int8@32:ocp/e2m1@32:ocp", 16), (48, "int8@32:ocp/e2m1@32:ocp", 16),
    (64, "int8@64:ocp/e2m1@64:ocp", 0), (64, "int8@32:ocp/e2m1@32:ocp", 32),
    (96, "int8@32:ocp/int8@32:ocp", 0)])
def test_decode_predicates_match_reference_dispatch(d, kv, pad):
    """``decode_kernel_takes`` / ``paged_decode_kernel_takes`` are False
    exactly where the reference's dispatch returns None; a layout they
    take but a kernel is not built for (bf16 q at D 96) raises in the
    wrapper on the card, as the reference runs its kernel there."""
    from repro.core.spec import QuantSpec as JSpec
    from repro.kernels import ops as jops
    from repro_torch.core.spec import QuantSpec as TSpec
    from repro_torch.kernels import mx_decode_attn as tattn
    kk, kv_ = (JSpec.parse(x) for x in kv.split("/"))
    tk, tv = (TSpec.parse(x) for x in kv.split("/"))
    rng = np.random.default_rng(11)
    b, s, hkv, rep, cw = 1, 8, 2, 2, d + pad
    q = jnp.asarray(rng.normal(size=(b, 1, hkv * rep, d)), jnp.float32)
    sw = -(-cw // kk.block)
    cache = {n: jnp.zeros((b, s, hkv, w), jnp.uint8) for n, w in
             (("k_codes", cw), ("v_codes", cw), ("k_scales", sw),
              ("v_scales", sw))}
    want = not _ref_ctx_none(jops.mx_decode_attention_ctx, q, cache,
                             jnp.asarray(3, jnp.int32), kk=kk, kv=kv_)
    assert tattn.decode_kernel_takes(d, tk, tv, (cw, cw)) == want
    widths = (tk.storage_nbytes(cw), tv.storage_nbytes(cw))
    pool = {n: jnp.zeros((3, 4, hkv, w), jnp.uint8) for n, w in
            (("kc_pages", widths[0]), ("vc_pages", widths[1]),
             ("ks_pages", sw), ("vs_pages", sw))}
    bt = jnp.asarray([[1, 2]], jnp.int32)
    want = not _ref_ctx_none(jops.mx_paged_decode_attention_ctx, q, pool, bt,
                             jnp.asarray([5], jnp.int32), kk=kk, kv=kv_)
    assert tattn.paged_decode_kernel_takes(d, tk, tv, widths, sw) == want


def test_flash_predicate():
    """Flash takes every head dim up to 128, as the reference's kernel
    takes any: on the card a head dim runs at the least compiled one
    (32, 64, 128) at or above it, zero-padded; past 128 the wrapper
    raises (no configuration has such a head dim)."""
    from repro_torch.kernels.flash_attn import kernel_head_dim
    assert [kernel_head_dim(d) for d in (8, 16, 24, 32, 40, 48, 64, 80,
                                         96, 128)] \
        == [32, 32, 32, 32, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="past the largest"):
        kernel_head_dim(136)


# =============================================================================
# attn_impl, and the paged suffix prefill of prefix caching
# =============================================================================
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_attn_impl_routes_match_reference(einsum_matmul, attn_impl):
    """Both values of ``attn_impl`` on the port match the reference at the
    same value: the causal forward and a prefill over an fp cache (flash
    kernel or dense), two decode steps over a contiguous MX cache (MX
    decode kernel or dense) and a paged decode step over an MX pool
    (paged kernel or dense).  Logits within 1e-4, this file's tolerance
    for prefill and decode logits."""
    jcfg, tcfg, jp, tp = _pair("weights=e4m3@32:ocp", attn_impl)
    tokens = np.random.default_rng(12).integers(0, 512, size=(2, 20))
    tokens = tokens.astype(np.int32)
    jlog, _, _ = jax.jit(lambda p, t: jdec.prefill(p, t, jcfg,
                                                   max_len=24))(
        jp, jnp.asarray(tokens))
    tlog, _, _ = tdec.prefill(tp, torch.from_numpy(tokens), tcfg,
                              max_len=24)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(
        tdec.forward(tp, torch.from_numpy(tokens), tcfg).numpy(),
        np.asarray(jlog), atol=1e-4, rtol=0)
    jcfg, tcfg, jp, tp = _pair(POLICY, attn_impl)
    cache = _random_cache(jcfg)
    jcache = {"layers": {n: jnp.asarray(a) for n, a in cache.items()}}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    steps = np.random.default_rng(13).integers(0, 512, size=(2, 2))
    steps = steps.astype(np.int32)
    jstep = jax.jit(lambda *a: jdec.decode_step(*a, jcfg))
    for pos in (12, 13):
        jlog, jcache = jstep(jp, jnp.asarray(steps[:, pos - 12]), jcache,
                             jnp.asarray(pos, jnp.int32))
        tlog, tcache = tdec.decode_step(
            tp, torch.from_numpy(steps[:, pos - 12]), tcache, pos, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0)
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


@pytest.mark.parametrize("policy", [POLICY, "weights=e4m3@32:ocp"])
def test_paged_prefill_suffix_logits_match(einsum_matmul, policy):
    """The suffix prefill over a pool whose prefix pages are filled (MX
    pages by the reference's converter, or fp pages): logits of every
    live row within 1e-4 of the reference's ``paged_prefill_suffix`` (the
    prefill-logits tolerance of this file); rows past a prompt are
    padding the engine never reads (their keys differ: the port zeroes
    values past the prompt).  Then the pages (the trash page left out):
    an MX pool's bytes identical, an fp pool within 1e-5."""
    jcfg, tcfg, jp, tp = _pair(policy)
    if jcfg.mx.kv_key is not None:
        pool = _random_pool(jcfg)
    else:
        rng = np.random.default_rng(14)
        pool = {n: rng.normal(size=(jcfg.n_layers, NUM_PAGES, PAGE, 2, 32))
                .astype(np.float32) for n in ("k_pages", "v_pages")}
    # slot 0: 9 cached positions, suffix 9..19; slot 1: 16 cached, 16..21;
    # slot 2: 3 cached, 3..6 — bucket S 11
    bt = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 0]], np.int32)
    starts = np.array([9, 16, 3], np.int32)
    lens = np.array([20, 22, 7], np.int32)
    s = 11
    tokens = np.random.default_rng(15).integers(0, 512, size=(3, s))
    tokens = tokens.astype(np.int32)
    jlog, jpool = jax.jit(lambda *a: jdec.paged_prefill_suffix(*a, jcfg))(
        jp, jnp.asarray(tokens), jnp.asarray(starts), jnp.asarray(lens),
        {"layers": {n: jnp.asarray(a) for n, a in pool.items()}},
        jnp.asarray(bt))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tlog, _ = tdec.paged_prefill_suffix(
        tp, torch.from_numpy(tokens), torch.from_numpy(starts),
        torch.from_numpy(lens), tpool, torch.from_numpy(bt), tcfg)
    jlog = np.asarray(jlog)
    for g in range(3):
        n = lens[g] - starts[g]
        np.testing.assert_allclose(tlog.numpy()[g, :n], jlog[g, :n],
                                   atol=1e-4, rtol=0)
    for n, a in jpool["layers"].items():
        want, got = np.asarray(a)[:, 1:], tpool[n].numpy()[:, 1:]
        if jcfg.mx.kv_key is None:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=n)
