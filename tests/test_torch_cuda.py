"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them each one skips
(decided inside the fixture, never at import).  This file imports neither
jax nor the JAX package, so it also runs on a machine without them:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core import MXWeight
from repro_torch.core.formats import ALL_FORMATS
from repro_torch.core.pack import pack_codes, packed_nbytes
from repro_torch.core.spec import QuantSpec
from repro_torch.kernels import mx_decode_attn, ref
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                mx_paged_decode_attention)
from repro_torch.kernels.mx_matmul import mx_matmul_2d
from repro_torch.kernels.mx_quant import mx_quantize_2d

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

FMTS = [f.name for f in ALL_FORMATS]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _special_rows(rng, n):
    x = rng.normal(size=(8, n)).astype(np.float32)
    x[1] *= np.float32(1e-39)                      # f32 subnormals
    x[2, 5] = np.nan
    x[3, 7] = np.inf
    x[4, 9] = -np.inf
    x[5] = 0.0
    x[6] = rng.standard_cauchy(size=n).astype(np.float32) * 1e4
    x[7] *= np.exp2(rng.integers(-140, 120, size=n)).astype(np.float32)
    return x


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_kernel_bit_identical(dev, fmt, mode):
    rng = np.random.default_rng(0)
    spec = QuantSpec(fmt, mode)
    for n in (128, 77):
        x = torch.from_numpy(_special_rows(rng, n))
        c_ref, s_ref = mx_quantize_2d(x, spec)
        c, s = mx_quantize_2d(x.to(dev), spec)
        torch.cuda.synchronize()
        assert torch.equal(c.cpu(), c_ref) and torch.equal(s.cpu(), s_ref)


@pytest.mark.parametrize("m", [5, 40])
@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_matmul_kernel_matches_plain(dev, fmt, mode, m):
    """Packed and unpacked storage, f32 and bf16 activations; rtol/atol
    1e-5 relative to the output scale (f32 sums in another order)."""
    rng = np.random.default_rng(1)
    k, n = 256, 200
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.05)
    for packed in (True, False):
        mw = MXWeight.quantize(w, QuantSpec(fmt, mode, 32, packed))
        for dt in (torch.float32, torch.bfloat16):
            want = mx_matmul_2d(a.to(dt), mw.codes, mw.scales, mw.spec)
            got = mx_matmul_2d(a.to(dt).to(dev), mw.codes.to(dev),
                               mw.scales.to(dev), mw.spec)
            torch.cuda.synchronize()
            tol = 1e-5 * float(want.abs().max())
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("spec", ["e4m3@32:ocp", "e2m1@32:ocp",
                                  "e3m2@32:paper"])
def test_matmul_rows_do_not_depend_on_batch(dev, spec):
    """The decode (M <= 16) and prefill (M > 16) kernels group K alike: a
    row's output is bit-identical whatever else shares the call."""
    rng = np.random.default_rng(4)
    k, n = 4096, 264
    a = torch.from_numpy(rng.normal(size=(40, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.02)
    mw = MXWeight.quantize(w.to(dev), QuantSpec.parse(spec))
    a = a.to(dev).to(torch.bfloat16)
    full = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
    for lo, hi in ((0, 8), (3, 4), (8, 24), (24, 40), (0, 16)):
        part = mx_matmul_2d(a[lo:hi].contiguous(), mw.codes, mw.scales,
                            mw.spec)
        assert torch.equal(part, full[lo:hi])


@pytest.mark.parametrize("spec", ["e4m3@32:ocp", "e2m1@32:ocp",
                                  "e3m2@32:paper"])
def test_matmul_rows_do_not_depend_on_tile_edges(dev, spec):
    """bf16 rows of slices that cross the 128-row prefill tiles of an
    M=300 call (decode-shape slices of 16 and 10 rows, a prefill-shape
    slice of 60 rows at another tile offset) are bit-identical to the same
    rows of the full call."""
    rng = np.random.default_rng(7)
    k, n = 4096, 264
    a = torch.from_numpy(rng.normal(size=(300, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.02)
    mw = MXWeight.quantize(w.to(dev), QuantSpec.parse(spec))
    a = a.to(dev).to(torch.bfloat16)
    full = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
    for lo, hi in ((120, 136), (250, 260), (100, 160), (127, 129)):
        part = mx_matmul_2d(a[lo:hi].contiguous(), mw.codes, mw.scales,
                            mw.spec)
        assert torch.equal(part, full[lo:hi])


@pytest.mark.parametrize("m", [8, 300])
@pytest.mark.parametrize("spec", ["e4m3@32:ocp", "e2m1@32:ocp",
                                  "e3m2@32:paper"])
def test_matmul_bf16_at_w1_width(dev, spec, m):
    """bf16 activations at chatglm3-6b's w1 shape (K 4096, N 13696), both
    shapes of the tensor-core kernel, against the plain version on the
    card; rtol/atol 1e-5 relative to the output scale, as above."""
    rng = np.random.default_rng(8)
    k, n = 4096, 13696
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.016)
    mw = MXWeight.quantize(w.to(dev), QuantSpec.parse(spec))
    a = a.to(dev).to(torch.bfloat16)
    got = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
    want = mx_matmul_2d(a.cpu(), mw.codes.cpu(), mw.scales.cpu(), mw.spec)
    torch.cuda.synchronize()
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=tol)


def _paged_case(rng, kspec, vspec, b=3, hq=4, hkv=2, d=64, page=8, npg=5):
    n_pool = b * npg + 1
    q = torch.from_numpy(rng.normal(size=(b, 1, hq, d)).astype(np.float32))

    def pool(spec):
        x = torch.from_numpy(
            rng.normal(size=(n_pool * page * hkv, d)).astype(np.float32))
        c, s = mx_quantize_2d(x, spec)
        if spec.packed:
            c = pack_codes(c, spec.fmt)
        cb = spec.storage_nbytes(d)
        return (c.reshape(n_pool, page, hkv, cb),
                s.reshape(n_pool, page, hkv, d // 32))

    kc, ks = pool(kspec)
    vc, vs = pool(vspec)
    perm = rng.permutation(np.arange(1, n_pool))[:b * npg]
    bt = torch.from_numpy(perm.reshape(b, npg).astype(np.int32))
    bt[2, 2:] = 0                                  # trash-padded row
    lengths = torch.tensor([npg * page - 1, 0, 2 * page - 3],
                           dtype=torch.int32)
    return q, kc, ks, vc, vs, bt, lengths


@pytest.mark.parametrize("kv", ["int8@32:ocp/int8@32:ocp",
                                "e4m3@32:ocp/e4m3@32:ocp",
                                "e2m1@32:ocp/e2m1@32:ocp",
                                "int8@32:ocp/e2m1@32:ocp",
                                "e3m2@32:paper/e2m3@32:paper"])
def test_paged_attention_kernel_matches_plain(dev, kv):
    ks_, vs_ = (QuantSpec.parse(s) for s in kv.split("/"))
    rng = np.random.default_rng(2)
    args = _paged_case(rng, ks_, vs_)
    want = mx_paged_decode_attention(*args, key_spec=ks_, value_spec=vs_,
                                     rep=2)
    got = mx_paged_decode_attention(*(t.to(dev) for t in args),
                                    key_spec=ks_, value_spec=vs_, rep=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    assert packed_nbytes(vs_.fmt, 64) == args[3].shape[-1]


def _contiguous_case(rng, kspec, vspec, b=3, s=80, hq=8, hkv=2, d=64):
    q = torch.from_numpy(rng.normal(size=(b, 1, hq, d)).astype(np.float32))
    out = [q]
    for spec in (kspec, vspec):
        x = torch.from_numpy(
            rng.normal(size=(b * s * hkv, d)).astype(np.float32))
        c, sc = mx_quantize_2d(x, spec)
        out += [c.reshape(b, s, hkv, d), sc.reshape(b, s, hkv, d // 32)]
    return out


@pytest.mark.parametrize("kv", ["int8@32:ocp/int8@32:ocp",
                                "int8@32:ocp/e2m1@32:ocp",
                                "e4m3@32:paper/e4m3@32:paper"])
def test_decode_attention_kernel_matches_plain(dev, kv):
    """Every position count from one tile to past a split boundary;
    f32 q within 2e-5, bf16 q within torch's bf16 defaults."""
    ks_, vs_ = (QuantSpec.parse(s) for s in kv.split("/"))
    args = _contiguous_case(np.random.default_rng(5), ks_, vs_)
    kw = dict(key_spec=ks_, value_spec=vs_, rep=4)
    for pos in (0, 1, 15, 31, 32, 57, 79, 200):
        for dt in (torch.float32, torch.bfloat16):
            q = args[0].to(dt)
            want = mx_decode_attention(q, *args[1:], pos, **kw)
            got = mx_decode_attention(q.to(dev),
                                      *(t.to(dev) for t in args[1:]), pos,
                                      **kw)
            torch.cuda.synchronize()
            if dt == torch.float32:
                torch.testing.assert_close(got.cpu(), want, rtol=2e-5,
                                           atol=2e-5)
            else:
                torch.testing.assert_close(got.cpu(), want)


# bf16 q, tensor-core kernels (csrc/mx_decode_attn_tc.cu): rep 16, 7, 1 and
# 32 (two m-tiles), D 64 and 128, positions at tile (16), split (64) and
# page edges; held to torch's bf16 defaults against the plain version
TC_SHAPES = [(16, 2, 128), (7, 2, 64), (1, 2, 64), (32, 1, 128),
             (16, 1, 64)]
TC_POSITIONS = (0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 575, 639)


def _bf16_contiguous(rng, rep, hkv, d, kv="int8@32:ocp/e2m1@32:ocp", b=3,
                     s=640):
    ks_, vs_ = (QuantSpec.parse(x) for x in kv.split("/"))
    args = _contiguous_case(rng, ks_, vs_, b=b, s=s, hq=hkv * rep, hkv=hkv,
                            d=d)
    args[0] = args[0].to(torch.bfloat16)
    return args, dict(key_spec=ks_, value_spec=vs_, rep=rep)


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_decode_attention_tc_matches_plain(dev, shape):
    rep, hkv, d = shape
    args, kw = _bf16_contiguous(np.random.default_rng(rep + d), rep, hkv, d)
    on_dev = [t.to(dev) for t in args]
    for pos in TC_POSITIONS:
        want = mx_decode_attention(*args, pos, **kw)
        got = mx_decode_attention(*on_dev, pos, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.cpu(), want,
                                   msg=lambda m: f"pos {pos}: {m}")


def _bf16_paged(rng, kspec, vspec, rep=16, hkv=2, d=128, page=16, npg=40,
                scale_code=None):
    """8 slots with ragged lengths at page and split edges (an idle slot
    of length 0), trash-padded block-table rows; bf16 q x 2."""
    b = 8
    lengths = torch.tensor([0, 1, 15, 16, 63, 64, 100, npg * page - 1],
                           dtype=torch.int32)
    n_pool = b * npg + 1
    q = torch.from_numpy(rng.normal(size=(b, 1, hkv * rep, d)).astype(
        np.float32) * 2).to(torch.bfloat16)

    def pool(spec):
        x = torch.from_numpy(
            rng.normal(size=(n_pool * page * hkv, d)).astype(np.float32))
        c, sc = mx_quantize_2d(x, spec)
        if spec.packed:
            c = pack_codes(c, spec.fmt)
        return (c.reshape(n_pool, page, hkv, -1),
                sc.reshape(n_pool, page, hkv, d // 32))

    kc, ks = pool(kspec)
    vc, vs = pool(vspec)
    bt = torch.from_numpy(rng.permutation(np.arange(1, n_pool)).reshape(
        b, npg).astype(np.int32))
    live = (lengths.long() // page + 1)[:, None]
    bt = torch.where(torch.arange(npg)[None] < live, bt, 0).to(torch.int32)
    if scale_code is not None:      # one block of the last slot below 10
        ks[bt[-1, 0], 1, 0, 0] = scale_code
        vs[bt[-1, 0], 1, 0, 0] = scale_code
    return (q, kc, ks, vc, vs, bt, lengths), dict(
        key_spec=kspec, value_spec=vspec, rep=rep)


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_paged_attention_tc_matches_plain(dev, fmt, mode):
    """Every format and mode in the pools (one code per byte, 4-bit and
    6-bit packed), K and V of one format, and K INT8 with it as V."""
    spec = QuantSpec(fmt, mode)
    rng = np.random.default_rng(FMTS.index(fmt))
    for kspec in (spec, QuantSpec("int8", mode)):
        args, kw = _bf16_paged(rng, kspec, spec)
        want = mx_paged_decode_attention(*args, **kw)
        got = mx_paged_decode_attention(*(t.to(dev) for t in args), **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), want,
                                   msg=lambda m: f"K {kspec}: {m}")


def test_decode_attention_tc_shapes_and_page_sizes(dev):
    """Paged: rep 7, 1 and 32 at D 64, page 8 (a 16-position tile spans
    two pages)."""
    rng = np.random.default_rng(11)
    ks_, vs_ = QuantSpec.parse("int8@32:ocp"), QuantSpec.parse("e2m1@32:ocp")
    for rep, hkv, d, page in ((7, 2, 64, 8), (1, 2, 64, 16),
                              (32, 1, 128, 8)):
        args, kw = _bf16_paged(rng, ks_, vs_, rep=rep, hkv=hkv, d=d,
                               page=page, npg=80 if page == 8 else 40)
        want = mx_paged_decode_attention(*args, **kw)
        got = mx_paged_decode_attention(*(t.to(dev) for t in args), **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), want,
                                   msg=lambda m: f"rep {rep}: {m}")


def test_decode_attention_tc_low_scale_block(dev):
    """A block with scale code 5 (E5M2: the bf16 fold rounds below code
    10) in K and V, held to the same criterion."""
    spec = QuantSpec.parse("e5m2@32:ocp")
    args, kw = _bf16_paged(np.random.default_rng(12), spec, spec,
                           scale_code=5)
    want = mx_paged_decode_attention(*args, **kw)
    got = mx_paged_decode_attention(*(t.to(dev) for t in args), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want)
    cargs, ckw = _bf16_contiguous(np.random.default_rng(13), 16, 2, 128,
                                  kv="e5m2@32:ocp/e5m2@32:ocp")
    cargs[2].view(-1, 4)[1, 0] = 5
    cargs[4].view(-1, 4)[1, 0] = 5
    want = mx_decode_attention(*cargs, 575, **ckw)
    got = mx_decode_attention(*(t.to(dev) for t in cargs), 575, **ckw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want)


def test_decode_attention_tc_one_split_per_row(dev, monkeypatch):
    """With one split per row every warp walks many tiles: the codes of
    the next tile in flight, the online rescale across tiles."""
    monkeypatch.setattr(mx_decode_attn, "SPLIT_BLOCKS", 1)
    rng = np.random.default_rng(14)
    args, kw = _bf16_contiguous(rng, 16, 2, 128)
    for pos in (65, 575, 639):
        want = mx_decode_attention(*args, pos, **kw)
        got = mx_decode_attention(*(t.to(dev) for t in args), pos, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), want)
    spec = QuantSpec.parse("e3m2@32:paper")
    pargs, pkw = _bf16_paged(rng, QuantSpec.parse("int8@32:ocp"), spec)
    want = mx_paged_decode_attention(*pargs, **pkw)
    got = mx_paged_decode_attention(*(t.to(dev) for t in pargs), **pkw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want)


def test_decode_attention_tc_is_deterministic(dev):
    """No atomics: two calls give the same bits."""
    rng = np.random.default_rng(15)
    args, kw = _bf16_contiguous(rng, 16, 2, 128, b=8)
    args = [t.to(dev) for t in args]
    assert torch.equal(mx_decode_attention(*args, 575, **kw),
                       mx_decode_attention(*args, 575, **kw))
    pargs, pkw = _bf16_paged(rng, QuantSpec.parse("int8@32:ocp"),
                             QuantSpec.parse("e2m1@32:ocp"))
    pargs = [t.to(dev) for t in pargs]
    assert torch.equal(mx_paged_decode_attention(*pargs, **pkw),
                       mx_paged_decode_attention(*pargs, **pkw))


@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 2, 32, True),
    (1, 77, 77, 4, 1, 64, True),          # ragged S
    (2, 300, 300, 4, 2, 128, True),
    (1, 64, 256, 2, 2, 128, True),        # Sq != Sk: top-left causal
    (1, 200, 100, 2, 1, 64, True),        # Sq > Sk
    (2, 64, 130, 4, 2, 64, False),        # non-causal, ragged Sk
    (1, 192, 192, 16, 1, 128, True),      # rep 16, the serving ratio
    (2, 512, 512, 32, 2, 128, True),      # B 2 x Sq 512, H 32 / Hkv 2
    (1, 77, 77, 16, 1, 128, True),        # ragged at rep 16
    (2, 130, 200, 8, 2, 128, False),      # non-causal, ragged Sk, D 128
])
def test_flash_kernel_matches_plain(dev, case):
    """f32 (csrc/flash_attn.cu, CUDA cores) at 2e-5; bf16
    (csrc/flash_attn_tc.cu, tensor cores) at the reference's bf16
    tolerance, 2e-2: P is rounded to bf16 before P V (at most 2^-9
    max|v|) and the output to bf16."""
    b, sq, sk, h, hkv, d, causal = case
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        args = [t.to(dt) for t in (q, k, v)]
        want = flash_attention(*args, causal=causal)
        got = flash_attention(*(t.to(dev) for t in args), causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == q.shape
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)


def test_flash_tc_kernel_is_deterministic(dev):
    """No atomics: two calls give the same bits."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16).to(dev)
               for shape in ((2, 300, 32, 128), (2, 300, 2, 128),
                             (2, 300, 2, 128)))
    a = flash_attention(q, k, v)
    b = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_cuda_tensor_never_takes_the_plain_path(dev):
    """A CUDA tensor launches the kernel: the counter moves."""
    before = mx_quantize_2d.launches
    mx_quantize_2d(torch.ones(2, 32, device=dev), "int8@32:ocp")
    assert mx_quantize_2d.launches == before + 1
    with pytest.raises(ValueError):
        mx_quantize_2d(torch.ones(2, 32, device=dev, dtype=torch.float16),
                       "int8@32:ocp")
    spec = QuantSpec.parse("int8@32:ocp")
    codes = torch.zeros(1, 40, 2, 64, dtype=torch.uint8, device=dev)
    scales = torch.full((1, 40, 2, 2), 127, dtype=torch.uint8, device=dev)
    before = mx_decode_attention.launches
    mx_decode_attention(torch.ones(1, 1, 4, 64, device=dev), codes, scales,
                        codes, scales, 39, key_spec=spec, value_spec=spec,
                        rep=2)
    assert mx_decode_attention.launches == before + 1
    with pytest.raises(ValueError):             # f16 q: raise, no plain path
        mx_decode_attention(torch.ones(1, 1, 4, 64, device=dev,
                                       dtype=torch.float16),
                            codes, scales, codes, scales, 39,
                            key_spec=spec, value_spec=spec, rep=2)
    q16 = torch.ones(1, 1, 4, 64, device=dev, dtype=torch.bfloat16)
    before = mx_decode_attention.launches       # bf16: the tensor-core one
    mx_decode_attention(q16, codes, scales, codes, scales, 39,
                        key_spec=spec, value_spec=spec, rep=2)
    assert mx_decode_attention.launches == before + 1
    pool = torch.zeros(3, 16, 2, 64, dtype=torch.uint8, device=dev)
    pscales = torch.full((3, 16, 2, 2), 127, dtype=torch.uint8, device=dev)
    bt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    lengths = torch.tensor([20], dtype=torch.int32, device=dev)
    for q in (q16, q16.float()):                # either kernel counts once
        before = mx_paged_decode_attention.launches
        mx_paged_decode_attention(q, pool, pscales, pool, pscales, bt,
                                  lengths, key_spec=spec, value_spec=spec,
                                  rep=2)
        assert mx_paged_decode_attention.launches == before + 1
    for dt in (torch.float32, torch.bfloat16):  # either kernel counts once
        x = torch.ones(1, 16, 4, 64, device=dev, dtype=dt)
        before = flash_attention.launches
        flash_attention(x, x, x)
        assert flash_attention.launches == before + 1
    with pytest.raises(ValueError):             # head dim 48: no kernel
        y = torch.ones(1, 16, 4, 48, device=dev)
        flash_attention(y, y, y)


def test_paged_reference_agrees_on_card(dev):
    """The plain version itself runs on the card and matches its CPU run."""
    spec = QuantSpec.parse("int8@32:ocp")
    rng = np.random.default_rng(3)
    args = _paged_case(rng, spec, spec)
    a = ref.mx_paged_decode_attention_ref(*args, key_spec=spec,
                                          value_spec=spec, rep=2)
    b = ref.mx_paged_decode_attention_ref(*(t.to(dev) for t in args),
                                          key_spec=spec, value_spec=spec,
                                          rep=2)
    torch.testing.assert_close(b.cpu(), a, rtol=2e-5, atol=2e-5)
