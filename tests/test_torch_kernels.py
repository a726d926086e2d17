"""The plain versions of the port's kernels against the JAX package.

On a CPU tensor each kernel wrapper computes its plain PyTorch version;
these tests hold those against the JAX package: the converter bit for bit
against the Pallas kernel in interpret mode, the dequant x matmul against
``mx_matmul_2d_ref`` (rtol/atol 1e-5: f32 sums in another order), and
paged decode attention against ``mx_paged_decode_attention_ref`` at 2e-5,
the tolerance of tests/test_paged_attn.py.  The kernels themselves run in
tests/test_torch_cuda.py, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import ALL_FORMATS
from repro.core.pack import pack_codes as jpack_codes
from repro.core.pack import pack_codes_rows as jpack_codes_rows
from repro.core.spec import QuantSpec as JSpec
from repro.kernels import ref as jref
from repro.kernels.flash_attn import flash_attention as j_flash
from repro.kernels.mx_decode_attn import mx_decode_attention as j_decode_attn
from repro.kernels.mx_quant import mx_quantize_2d as j_quant_2d
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                mx_paged_decode_attention)
from repro_torch.kernels.mx_matmul import mx_matmul_2d, split_count
from repro_torch.kernels.mx_quant import mx_quantize_2d

torch.set_num_threads(1)

FMTS = [f.name for f in ALL_FORMATS]


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_plain_quantize_matches_pallas_interpret(fmt, mode):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 160)).astype(np.float32)
    x[1] *= np.float32(1e-39)
    x[2, 3], x[3, 50], x[4, 99] = np.nan, np.inf, -np.inf
    x[5] = 0.0
    x[6] *= np.exp2(rng.integers(-120, 120, size=160)).astype(np.float32)
    before = mx_quantize_2d.launches
    for n in (77,):                          # not a multiple of 32
        jc, js = j_quant_2d(jnp.asarray(x[:, :n]), JSpec(fmt, mode),
                            interpret=True)
        tc, ts = mx_quantize_2d(torch.from_numpy(x[:, :n].copy()),
                                TSpec(fmt, mode))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert mx_quantize_2d.launches == before   # a CPU tensor: no launch


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_plain_matmul_matches_reference(fmt, mode):
    """Random finite codes of the format's width and scales near 2^0,
    packed along K and unpacked."""
    f = next(ff for ff in ALL_FORMATS if ff.name == fmt)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 128)).astype(np.float32)
    codes = rng.integers(0, 2 ** f.code_bits, size=(128, 40))
    if not f.is_int:                     # keep clear of NaN/Inf encodings
        codes &= ~(1 << (f.ebits + f.mbits - 1))
    codes = codes.astype(np.uint8)
    scales = rng.integers(120, 130, size=(4, 40)).astype(np.uint8)
    want = np.asarray(jref.mx_matmul_2d_ref(
        jnp.asarray(a), jnp.asarray(codes), jnp.asarray(scales),
        JSpec(fmt, mode, 32, False)))
    for packed in (True, False):
        stored = np.array(jpack_codes_rows(jnp.asarray(codes), fmt)) \
            if packed else codes
        got = mx_matmul_2d(torch.from_numpy(a), torch.from_numpy(stored),
                           torch.from_numpy(scales),
                           TSpec(fmt, mode, 32, packed))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_split_count_ignores_batch():
    """K splits depend on (N, K) only: a row's sum order never depends on
    which other rows share the call."""
    assert split_count(4096, 4096, 132) == 32       # wq/wo
    assert split_count(256, 4096, 132) == 64        # wk/wv
    assert split_count(13696, 4096, 132) == 10      # w1/w3
    assert split_count(4096, 13696, 132) == 33      # w2: <= 24 chunks each
    assert split_count(65536, 64, 132) == 1


B, HQ, HKV, D, PAGE, NPG = 4, 4, 2, 64, 8, 5


def _paged_case(kspec, vspec, seed=0):
    """A page pool filled by the reference converter, shuffled block
    tables, one trash-padded row and one lengths == 0 slot."""
    rng = np.random.default_rng(seed)
    n_pool = B * NPG + 1
    q = rng.normal(size=(B, 1, HQ, D)).astype(np.float32)

    def pool(spec):
        x = rng.normal(size=(n_pool, PAGE, HKV, D)).astype(np.float32)
        x[0] = 0.0                                   # the trash page
        codes, scales = jref.mx_quantize_2d_ref(
            jnp.asarray(x.reshape(-1, D)), spec)
        codes = codes.reshape(n_pool, PAGE, HKV, D)
        if spec.packed:
            codes = jpack_codes(codes, spec.fmt)
        return (np.asarray(codes),
                np.asarray(scales).reshape(n_pool, PAGE, HKV, D // 32))

    kc, ks = pool(kspec)
    vc, vs = pool(vspec)
    bt = rng.permutation(np.arange(1, n_pool)).reshape(B, NPG)
    bt = bt.astype(np.int32)
    bt[2, 2:] = 0                                    # trash-padded row
    bt[3, :] = 0                                     # idle slot
    lengths = np.array([NPG * PAGE - 1, 13, 2 * PAGE - 3, 0], np.int32)
    return q, kc, ks, vc, vs, bt, lengths


@pytest.mark.parametrize("kv", ["int8@32:ocp/int8@32:ocp",
                                "e4m3@32:ocp/e4m3@32:ocp",
                                "e2m1@32:ocp/e2m1@32:ocp",
                                "int8@32:ocp/e2m1@32:ocp"])
def test_plain_paged_attention_matches_reference(kv):
    kt, vt = kv.split("/")
    args = _paged_case(JSpec.parse(kt), JSpec.parse(vt))
    want = np.asarray(jref.mx_paged_decode_attention_ref(
        *(jnp.asarray(a) for a in args), key_spec=JSpec.parse(kt),
        value_spec=JSpec.parse(vt), rep=HQ // HKV))
    before = mx_paged_decode_attention.launches
    got = mx_paged_decode_attention(
        *(torch.from_numpy(np.array(a)) for a in args),
        key_spec=TSpec.parse(kt),
        value_spec=TSpec.parse(vt), rep=HQ // HKV)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert mx_paged_decode_attention.launches == before


def test_wrappers_validate_shapes():
    spec = TSpec.parse("e4m3@32:ocp")
    with pytest.raises(ValueError):
        mx_quantize_2d(torch.zeros(2, 3, 32), spec)
    with pytest.raises(ValueError):                  # codes rows mismatch
        mx_matmul_2d(torch.zeros(2, 64), torch.zeros(48, 8, dtype=torch.uint8),
                     torch.zeros(2, 8, dtype=torch.uint8), spec)
    with pytest.raises(ValueError):                  # block != 32
        mx_paged_decode_attention(
            torch.zeros(1, 1, 2, 32), *[torch.zeros(2, 4, 1, 32,
                                                    dtype=torch.uint8)] * 4,
            torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            key_spec=TSpec("int8", "ocp", 16), value_spec=spec, rep=2)


def _contiguous_cache(kspec, vspec, b=2, s=64, hkv=2, d=64, seed=0):
    """A contiguous MX cache filled by the reference converter (one code
    per byte, every format)."""
    rng = np.random.default_rng(seed)
    out = []
    for spec in (kspec, vspec):
        x = rng.normal(size=(b * s * hkv, d)).astype(np.float32)
        codes, scales = jref.mx_quantize_2d_ref(jnp.asarray(x), spec)
        out += [np.array(codes).reshape(b, s, hkv, d),
                np.array(scales).reshape(b, s, hkv, d // 32)]
    return out


@pytest.mark.parametrize("pos", [0, 63])
@pytest.mark.parametrize("kv", ["int8@32:ocp/int8@32:ocp",
                                "e4m3@32:paper/e4m3@32:paper",
                                "int8@32:ocp/e2m1@32:ocp"])
def test_plain_decode_attention_matches_pallas_interpret(kv, pos):
    kt, vt = kv.split("/")
    cache = _contiguous_cache(JSpec.parse(kt), JSpec.parse(vt))
    q = np.random.default_rng(1).normal(size=(2, 1, 4, 64)).astype(
        np.float32)
    want = np.asarray(j_decode_attn(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache),
        jnp.asarray(pos, jnp.int32), key_spec=JSpec.parse(kt),
        value_spec=JSpec.parse(vt), rep=2, interpret=True))
    before = mx_decode_attention.launches
    got = mx_decode_attention(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in cache), pos,
        key_spec=TSpec.parse(kt), value_spec=TSpec.parse(vt), rep=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert mx_decode_attention.launches == before


def _qkv(b, sq, sk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 2, 32, True, "float32"),     # causal GQA 2:1
    (1, 77, 77, 4, 1, 64, True, "float32"),       # ragged S, GQA 4:1
    (1, 64, 256, 2, 2, 32, True, "float32"),      # causal Sq != Sk: top-left
    (2, 64, 128, 4, 2, 32, False, "float32"),     # non-causal
    (2, 128, 128, 4, 2, 32, True, "bfloat16"),
])
def test_plain_flash_attention_matches_pallas_interpret(case):
    b, sq, sk, h, hkv, d, causal, dtype = case
    q, k, v = _qkv(b, sq, sk, h, hkv, d, seed=sq + sk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_flash(*(jnp.asarray(a, dtype=jdt) for a in (q, k, v)), causal,
                   True)
    before = flash_attention.launches
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == tdt and got.shape == (b, sq, h, d)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert flash_attention.launches == before


@pytest.mark.parametrize("d,dtype", [(16, "float32"), (24, "float32"),
                                     (48, "float32"), (96, "float32"),
                                     (48, "bfloat16")])
def test_flash_zero_padded_head_dim_matches_pallas_interpret(d, dtype):
    """What the card computes at a head dim the kernels are not built
    for: q, k and v zero-padded up to ``kernel_head_dim(d)``, scores
    scaled by 1/sqrt(d), the padded output columns dropped; the plain
    version of that against the Pallas kernel at head dim d."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import kernel_head_dim
    q, k, v = _qkv(2, 70, 70, 4, 2, d, seed=d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_flash(*(jnp.asarray(a, dtype=jdt) for a in (q, k, v)), True,
                   True)
    dk = kernel_head_dim(d)
    padded = (torch.nn.functional.pad(torch.from_numpy(a).to(tdt),
                                      (0, dk - d)) for a in (q, k, v))
    out = ref.flash_attention_ref(*padded, True, scale_d=d)
    assert dk > d and not out[..., d:].any()
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out[..., :d].float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_attention_wrappers_validate():
    spec = TSpec.parse("int8@32:ocp")
    q = torch.zeros(1, 1, 4, 64)
    codes = torch.zeros(1, 8, 2, 64, dtype=torch.uint8)
    scales = torch.zeros(1, 8, 2, 2, dtype=torch.uint8)
    ok = dict(key_spec=spec, value_spec=spec, rep=2)
    assert mx_decode_attention(q, codes, scales, codes, scales, 3,
                               **ok).shape == q.shape
    padded = torch.zeros(1, 8, 2, 96, dtype=torch.uint8)   # D=64 padded
    for args, kw in [((q, padded, scales, codes, scales, 3), ok),
                     ((q, codes, scales, codes, scales, -1), ok),
                     ((q, codes, scales, codes, scales, 3),
                      dict(ok, rep=4)),                    # Hq != Hkv x rep
                     ((q, codes, scales, codes, scales, 3),
                      dict(ok, key_spec=TSpec("int8", "ocp", 16)))]:
        with pytest.raises(ValueError):
            mx_decode_attention(*args, **kw)
    fq, fk = torch.zeros(1, 5, 4, 32), torch.zeros(1, 5, 3, 32)
    with pytest.raises(ValueError):                        # 4 % 3 heads
        flash_attention(fq, fk, fk)
    with pytest.raises(ValueError):                        # k/v differ
        flash_attention(fq, fq, torch.zeros(1, 6, 4, 32))
    with pytest.raises(ValueError):                        # no keys
        flash_attention(fq, fq[:, :0], fq[:, :0])
