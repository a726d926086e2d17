"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them each one skips
(decided inside the fixture, never at import).  This file imports neither
jax nor the JAX package, so it also runs on a machine without them:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import MXWeight
from repro_torch.core.formats import ALL_FORMATS
from repro_torch.core.pack import pack_codes, packed_nbytes
from repro_torch.core.spec import QuantPolicy, QuantSpec
from repro_torch.kernels import mx_decode_attn, ref
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                mx_paged_decode_attention)
from repro_torch.kernels.mx_kv_write import (mx_cache_kv_write,
                                             mx_paged_kv_write,
                                             mx_paged_kv_write_tokens)
from repro_torch.kernels.mx_matmul import mx_matmul_2d
from repro_torch.kernels.mx_quant import mx_quantize_2d, vectorized

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

FMTS = [f.name for f in ALL_FORMATS]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    # the deterministic train step needs cuBLAS's fixed workspace, set
    # before the first test's cuBLAS call (repro_torch.train.step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_vec_and_lane_kernels_bit_identical(dev, fmt, mode):
    """Both converter kernels: the vectorized one over rows a multiple of
    32 long (one block of special rows, and 2112 x 4096, enough groups for
    its grid-stride loop to wrap), the one-lane-per-element one over a
    ragged row and over rows that start off a 16-byte boundary."""
    rng = np.random.default_rng(4)
    spec = QuantSpec(fmt, mode)
    big = rng.normal(size=(2112, 4096)).astype(np.float32) * 0.02
    big[7] = _special_rows(rng, 4096)[3]
    flat = torch.from_numpy(_special_rows(rng, 513).reshape(-1))
    cases = [(torch.from_numpy(_special_rows(rng, 96)), True),
             (torch.from_numpy(big), True),
             (torch.from_numpy(_special_rows(rng, 45)), False)]
    on_dev = [(x.to(dev), want) for x, want in cases]
    buf = flat.to(dev)                         # rows start 4 bytes in
    on_dev.append((buf[1:1 + 16 * 256].view(16, 256), False))
    for x, want in on_dev:
        assert vectorized(x) == want
        c, s = mx_quantize_2d(x, spec)
        c_ref, s_ref = mx_quantize_2d(x.cpu(), spec)
        torch.cuda.synchronize()
        assert torch.equal(c.cpu(), c_ref) and torch.equal(s.cpu(), s_ref)


def _kv_pair(rng, shape, dtype, dev, special=False):
    """k and v on the card (and their CPU copies): normal values with an
    f32-subnormal row; ``special`` adds a NaN block and an Inf block."""
    out = []
    for _ in range(2):
        x = rng.normal(size=shape).astype(np.float32)
        x[..., 1, :] *= np.float32(1e-39)
        if special:
            x[0, 0, 0, 5] = np.nan
            x[-1, -1, -1, 40] = -np.inf
        t = torch.from_numpy(x).to(dtype)
        out += [t.to(dev), t]
    return out


def _pool_pair(rng, kspec, vspec, n_pages, page, n_kv, hd, dev):
    """Page pools of random bytes (so every written byte shows), on the
    card and on the CPU."""
    cl = -(-hd // 32) * 32
    shapes = {"kc_pages": kspec.storage_nbytes(cl), "ks_pages": cl // 32,
              "vc_pages": vspec.storage_nbytes(cl), "vs_pages": cl // 32}
    cpu = {n: torch.from_numpy(rng.integers(0, 256, size=(
        n_pages, page, n_kv, w)).astype(np.uint8)) for n, w in shapes.items()}
    return {n: t.to(dev) for n, t in cpu.items()}, cpu


@pytest.mark.parametrize("mode", ["paper", "ocp"])
@pytest.mark.parametrize("fmt", FMTS)
def test_paged_kv_write_matches_plain(dev, fmt, mode):
    """Every value format x mode beside INT8 and E4M3 keys, packed and
    unpacked pools, pages of 16 and 8, bf16 and f32 k/v, head dims 128 and
    48 (codes padded to 64): slots mid-page, at a page's last offset, at
    offset 0 of a fresh page, and two idle slots colliding on the trash
    page, which is left out of the check."""
    rng = np.random.default_rng(12)
    for kspec in ("int8@32:ocp", "e4m3@32:paper"):
        for packed in (True, False):
            kk = QuantSpec.parse(kspec)
            vv = QuantSpec(fmt, mode, 32, packed)
            for page, hd, dt in ((16, 128, torch.bfloat16),
                                 (8, 48, torch.float32)):
                b, n_kv, npg = 6, 2, 3
                dpool, cpool = _pool_pair(rng, kk, vv, 1 + b * npg, page,
                                          n_kv, hd, dev)
                bt = (1 + torch.arange(b * npg, dtype=torch.int32)) \
                    .reshape(b, npg)
                bt[4:] = 0
                lengths = torch.tensor([5, page - 1, page, 2 * page + 3,
                                        0, 0], dtype=torch.int32)
                kd, kc, vd, vc = _kv_pair(rng, (b, 1, n_kv, hd), dt, dev,
                                          special=mode == "paper")
                mx_paged_kv_write(dpool, kd, vd, bt.to(dev),
                                  lengths.to(dev), kk, vv)
                mx_paged_kv_write(cpool, kc, vc, bt, lengths, kk, vv)
                torch.cuda.synchronize()
                for n in cpool:
                    assert torch.equal(dpool[n].cpu()[1:], cpool[n][1:]), \
                        (kspec, str(vv), page, hd, n)


# a slot whose length lies past its 2-page table, or whose table names
# page 99 or page -1 of a 4-page pool (pages of 8)
BAD_SLOTS = {"length past the table": ([[1, 2], [3, 1]], [16, 9]),
             "page past the pool": ([[1, 2], [3, 99]], [5, 9]),
             "page below 0": ([[1, 2], [3, -1]], [5, 9])}

_BAD_SLOT_SCRIPT = """
import sys, torch
from repro_torch.core.spec import QuantSpec
from repro_torch.kernels.mx_kv_write import mx_paged_kv_write
bt, lengths = {bt!r}, {lengths!r}
kk = QuantSpec.parse("int8@32:ocp")
pool = {{n: torch.zeros(4, 8, 2, w, dtype=torch.uint8, device="cuda")
        for n, w in (("kc_pages", 64), ("ks_pages", 2), ("vc_pages", 64),
                     ("vs_pages", 2))}}
k = torch.ones(2, 1, 2, 64, device="cuda")
try:
    mx_paged_kv_write(pool, k, k, torch.tensor(bt, dtype=torch.int32,
                      device="cuda"), torch.tensor(lengths,
                      dtype=torch.int32, device="cuda"), kk, kk)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("case", sorted(BAD_SLOTS))
def test_paged_kv_write_rejects_rows_past_their_table(dev, case):
    """A slot the write cannot place is an error on both devices: the
    plain version raises, and the kernel traps, so its launch fails and
    the next synchronizing call raises.  A trap leaves the CUDA context
    unusable, so the card's half runs in a child process."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    bt, lengths = BAD_SLOTS[case]
    kk = QuantSpec.parse("int8@32:ocp")
    rng = np.random.default_rng(13)
    cpool = _pool_pair(rng, kk, kk, 4, 8, 2, 64, "cpu")[1]
    k = torch.ones(2, 1, 2, 64)
    with pytest.raises((IndexError, RuntimeError)):
        mx_paged_kv_write(cpool, k, k, torch.tensor(bt, dtype=torch.int32),
                          torch.tensor(lengths, dtype=torch.int32), kk, kk)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    run = subprocess.run(
        [sys.executable, "-c", _BAD_SLOT_SCRIPT.format(bt=bt,
                                                       lengths=lengths)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, (case, run.stdout, run.stderr[-2000:])


_BAD_TOKENS_SCRIPT = """
import sys, torch
from repro_torch.core.spec import QuantSpec
from repro_torch.kernels.mx_kv_write import mx_paged_kv_write_tokens
kk = QuantSpec.parse("int8@32:ocp")
pool = {n: torch.zeros(4, 8, 2, w, dtype=torch.uint8, device="cuda")
        for n, w in (("kc_pages", 64), ("ks_pages", 2), ("vc_pages", 64),
                     ("vs_pages", 2))}
k = torch.ones(2, 4, 2, 64, device="cuda")
bt = torch.tensor([[1, 2], [3, 1]], dtype=torch.int32, device="cuda")
starts = torch.tensor([14, 0], dtype=torch.int32, device="cuda")
ends = torch.tensor([18, 4], dtype=torch.int32, device="cuda")
try:   # row 0's live position 16 lies past its 2-page table
    mx_paged_kv_write_tokens(pool, k, k, bt, starts, ends, kk, kk)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("kv", ["int8@32:ocp/e2m1@32:ocp",
                                "e3m2@32:paper/e3m2@32:paper",
                                "e4m3@32:paper/e2m3@32:ocp+unpacked"])
def test_paged_kv_write_tokens_matches_plain_and_traps(dev, kv):
    """The multi-token paged write (the suffix prefill's): 8 rows of 64
    tokens from starts off page boundaries, tails of bucket padding on
    the trash page, bf16 (D 128, pages of 16) and f32 (D 48, pages of 8);
    every page but the trash page bit for bit against the plain version.
    A live position past its table traps (in a child process: a trap
    leaves the CUDA context unusable), as the plain version raises."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    kk, vv = (QuantSpec.parse(x) for x in kv.split("/"))
    rng = np.random.default_rng(16)
    g, s = 8, 64
    for page, hd, dt in ((16, 128, torch.bfloat16), (8, 48, torch.float32)):
        npg = -(-(3 * s) // page)
        dpool, cpool = _pool_pair(rng, kk, vv, 1 + g * npg, page, 2, hd,
                                  dev)
        bt = (1 + torch.randperm(g * npg, generator=torch.Generator()
                                 .manual_seed(page))).reshape(g, npg) \
            .to(torch.int32)
        starts = torch.from_numpy(rng.integers(
            0, 2 * s, size=g).astype(np.int32))
        starts[0] = page - 3                      # off a page boundary
        ends = starts + torch.from_numpy(rng.integers(
            1, s + 1, size=g).astype(np.int32))
        ends[1] = starts[1] + s                   # one row without padding
        kd, kc, vd, vc = _kv_pair(rng, (g, s, 2, hd), dt, dev,
                                  special="paper" in kv)
        before = mx_paged_kv_write_tokens.launches
        mx_paged_kv_write_tokens(dpool, kd, vd, bt.to(dev), starts.to(dev),
                                 ends.to(dev), kk, vv)
        assert mx_paged_kv_write_tokens.launches == before + 1
        mx_paged_kv_write_tokens(cpool, kc, vc, bt, starts, ends, kk, vv)
        torch.cuda.synchronize()
        for n in cpool:
            assert torch.equal(dpool[n].cpu()[1:], cpool[n][1:]), \
                (kv, page, hd, n)
    src = str(Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run([sys.executable, "-c", _BAD_TOKENS_SCRIPT],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, (run.stdout, run.stderr[-2000:])


@pytest.mark.parametrize("kv", ["int8@32:ocp/e2m1@32:ocp",
                                "e3m2@32:paper/e2m3@32:paper",
                                "e5m2@32:ocp/int8@32:paper"])
def test_cache_kv_write_matches_plain(dev, kv):
    """The contiguous cache at s 1 (decode) and 300 (a prefill crossing
    many warps' blocks), bf16 and f32, head dims 128 and 48."""
    kk, vv = (QuantSpec.parse(x) for x in kv.split("/"))
    rng = np.random.default_rng(14)
    for hd, dt in ((128, torch.bfloat16), (48, torch.float32)):
        cl = -(-hd // 32) * 32
        cpu = {n: torch.from_numpy(rng.integers(0, 256, size=(
            3, 320, 2, w)).astype(np.uint8)) for n, w in
            (("k_codes", cl), ("k_scales", cl // 32), ("v_codes", cl),
             ("v_scales", cl // 32))}
        dcache = {n: t.to(dev) for n, t in cpu.items()}
        for pos, s in ((0, 300), (300, 1), (319, 1)):
            kd, kc, vd, vc = _kv_pair(rng, (3, s, 2, hd), dt, dev,
                                      special="paper" in kv)
            mx_cache_kv_write(dcache, kd, vd, pos, kk, vv)
            mx_cache_kv_write(cpu, kc, vc, pos, kk, vv)
        torch.cuda.synchronize()
        for n in cpu:
            assert torch.equal(dcache[n].cpu(), cpu[n]), (kv, hd, n)


def test_kv_write_repeats_and_counts(dev):
    """Two calls write the same bytes; each launch counts once; operands
    the kernel does not take raise."""
    kk, vv = QuantSpec.parse("int8@32:ocp"), QuantSpec.parse("e2m1@32:ocp")
    rng = np.random.default_rng(15)
    pool = _pool_pair(rng, kk, vv, 9, 16, 2, 128, dev)[0]
    pools = [pool, {n: t.clone() for n, t in pool.items()}]
    kd, _, vd, _ = _kv_pair(rng, (8, 1, 2, 128), torch.bfloat16, dev)
    bt = torch.arange(1, 9, dtype=torch.int32, device=dev)[:, None]
    lengths = torch.arange(8, dtype=torch.int32, device=dev)
    for pool in pools:
        before = mx_paged_kv_write.launches
        mx_paged_kv_write(pool, kd, vd, bt, lengths, kk, vv)
        assert mx_paged_kv_write.launches == before + 1
    torch.cuda.synchronize()
    for n in pools[0]:
        assert torch.equal(pools[0][n], pools[1][n])
    cache = {n: torch.zeros(8, 4, 2, w, dtype=torch.uint8, device=dev)
             for n, w in (("k_codes", 128), ("k_scales", 4),
                          ("v_codes", 128), ("v_scales", 4))}
    before = mx_cache_kv_write.launches
    mx_cache_kv_write(cache, kd, vd, 3, kk, vv)
    assert mx_cache_kv_write.launches == before + 1
    with pytest.raises(ValueError):             # strided k: raise
        mx_paged_kv_write(pools[0], kd.transpose(2, 3).contiguous()
                          .transpose(2, 3), vd, bt, lengths, kk, vv)
    cache64 = dict(cache, k_scales=cache["k_scales"][..., :2].contiguous())
    with pytest.raises(ValueError, match="block=64"):
        mx_cache_kv_write(cache64, kd, vd, 3, QuantSpec("int8", "ocp", 64),
                          vv)
    with pytest.raises(ValueError):             # int64 tables: raise
        mx_paged_kv_write(pools[0], kd, vd, bt.long(), lengths, kk, vv)


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


@pytest.mark.parametrize("kn", [(2048, 1408), (1408, 2048)])
def test_matmul_through_expert_take_views(dev, kn):
    """moonshot-v1-16b-a3b's expert shapes: a stack of 4 experts quantized
    on the card, each expert's matmul launched on ``take(i)`` (views of
    the stack, no copy) at one row and at 30 rows, bf16 activations,
    against the plain version; rows equal bit for bit across the two."""
    k, n = kn
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.normal(size=(4, k, n)).astype(np.float32)
                         / np.sqrt(k)).to(dev)
    stack = MXWeight.quantize(w, QuantSpec.parse("e4m3@32:ocp"))
    a = torch.from_numpy(rng.normal(size=(4, 30, k)).astype(np.float32)) \
        .to(dev).to(torch.bfloat16)
    for i in range(4):
        wi = stack.take(i)
        assert wi.codes.data_ptr() == stack.codes.data_ptr() \
            + i * wi.codes.numel()
        got = mx_matmul_2d(a[i], wi.codes, wi.scales, wi.spec)
        one = mx_matmul_2d(a[i, :1], wi.codes, wi.scales, wi.spec)
        want = mx_matmul_2d(a[i].cpu(), wi.codes.cpu(), wi.scales.cpu(),
                            wi.spec)
        torch.cuda.synchronize()
        tol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=tol)
        assert torch.equal(one, got[:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_on_card_matches_cpu(dev, dtype):
    """``layers.moe`` on e4m3 expert stacks (reduced moonshot widths, 64
    tokens) on the card against its CPU run: the same routing, outputs
    within the matmul's tolerance (bf16: one bf16 rounding step)."""
    import dataclasses
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model, layers, load_reduced
    cfg = load_reduced("moonshot_v1_16b_a3b", dtype=dtype,
                       mx=QuantPolicy.parse("weights=e4m3@32:ocp"))
    params = Model(cfg, device="cpu").init(seed=2, quantize=True)
    moe = params["layers"][1]["moe"]
    on_dev = {"router": moe["router"].to(dev),
              "experts": {k: dataclasses.replace(
                  w, codes=w.codes.to(dev), scales=w.scales.to(dev))
                  for k, w in moe["experts"].items()},
              "shared": {k: dataclasses.replace(
                  w, codes=w.codes.to(dev), scales=w.scales.to(dev))
                  for k, w in moe["shared"].items()}}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)).to(cfg.torch_dtype)
    want, aux = layers.moe(moe, x, cfg)
    before = mx_matmul_2d.launches
    got, aux_d = layers.moe(on_dev, x.to(dev), cfg)
    torch.cuda.synchronize()
    assert mx_matmul_2d.launches - before == 3 * cfg.n_experts + 3
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol * float(want.abs().max()))
    torch.testing.assert_close(aux_d.cpu(), aux, rtol=1e-5, atol=1e-6)


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
             (16, 1, 64), (1, 16, 128), (7, 8, 128),   # moonshot, yi-34b
             (1, 32, 64), (1, 16, 64), (8, 8, 128)]    # zamba2, seamless,
#                                                        internvl2
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


@pytest.mark.parametrize("rep,hkv", [(1, 16), (7, 8)])
def test_paged_attention_tc_at_gqa_groups(dev, rep, hkv):
    """The GQA groups of moonshot-v1-16b-a3b (1 query head per KV head:
    15 of the 16 rows of an m16 tile are padding) and yi-34b (7), INT8
    keys and E2M1 values, against the plain version."""
    args, kw = _bf16_paged(np.random.default_rng(rep), QuantSpec.parse(
        "int8@32:ocp"), QuantSpec.parse("e2m1@32:ocp"), rep=rep, hkv=hkv,
        npg=12)
    want = mx_paged_decode_attention(*args, **kw)
    got = mx_paged_decode_attention(*(t.to(dev) for t in args), **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu(), want)


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
    (2, 300, 300, 4, 2, 48, True),        # D 48: zero-padded to 64
    (1, 77, 77, 4, 1, 16, True),          # D 16: zero-padded to 32
    (2, 64, 130, 4, 2, 96, False),        # D 96: zero-padded to 128
    (2, 130, 130, 4, 2, 192, True),       # D 192: zero-padded to 256
    (1, 77, 200, 2, 1, 256, True),        # D 256, Sq != Sk
    (2, 64, 130, 4, 2, 256, False),       # D 256, non-causal, ragged Sk
])
def test_flash_kernel_matches_plain(dev, case):
    """f32 (csrc/flash_attn.cu, CUDA cores) at 2e-5; bf16
    (csrc/flash_attn_tc.cu, tensor cores) at the reference's bf16
    tolerance, 2e-2: P is rounded to bf16 before P V (at most 2^-9
    max|v|) and the output to bf16.  Head dims the kernels are not built
    for run zero-padded, scaled by the true head dim."""
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
    y = torch.ones(1, 16, 4, 48, device=dev)    # head dim 48: zero-padded
    before = flash_attention.launches
    flash_attention(y, y, y)
    assert flash_attention.launches == before + 1
    y = torch.ones(1, 16, 4, 160, device=dev)   # head dim 160: padded to
    before = flash_attention.launches           # the 256 build
    flash_attention(y, y, y)
    assert flash_attention.launches == before + 1
    with pytest.raises(ValueError):             # head dim 288: no kernel
        y = torch.ones(1, 16, 4, 288, device=dev)
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


# ---------------------------------------------------------------------------
# positions in device memory, and the decode steps as captured CUDA graphs
# ---------------------------------------------------------------------------
POLICY = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"


@pytest.mark.parametrize("kv", ["int8@32:ocp/e2m1@32:ocp",
                                "e3m2@32:paper/e5m2@32:ocp"])
def test_cache_kv_write_device_pos_matches_plain(dev, kv):
    """The contiguous write at a pos the kernel reads from device memory
    writes the plain version's bytes, at s 1 and s 300."""
    kk, vv = (QuantSpec.parse(x) for x in kv.split("/"))
    rng = np.random.default_rng(21)
    cpu = {n: torch.from_numpy(rng.integers(0, 256, size=(
        3, 320, 2, w)).astype(np.uint8)) for n, w in
        (("k_codes", 128), ("k_scales", 4), ("v_codes", 128),
         ("v_scales", 4))}
    dcache = {n: t.to(dev) for n, t in cpu.items()}
    for pos, s in ((0, 300), (300, 1), (319, 1)):
        kd, kc, vd, vc = _kv_pair(rng, (3, s, 2, 128), torch.bfloat16, dev,
                                  special="paper" in kv)
        mx_cache_kv_write(dcache, kd, vd, torch.tensor(
            [pos], dtype=torch.int32, device=dev), kk, vv)
        mx_cache_kv_write(cpu, kc, vc, pos, kk, vv)
    torch.cuda.synchronize()
    for n in cpu:
        assert torch.equal(dcache[n].cpu(), cpu[n]), (kv, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_device_pos(dev, dtype):
    """Contiguous decode attention with pos in device memory: the host
    int's bits (the grid is sized from S either way) and the plain
    version's values, at the first, a middle and the last position."""
    rng = np.random.default_rng(22)
    args, kw = _bf16_contiguous(rng, 16, 2, 128, b=4)
    q = args[0].to(dtype)
    on_dev = [t.to(dev) for t in (q, *args[1:])]
    for pos in (0, 63, 64, 575, 639):
        pos_d = torch.tensor([pos], dtype=torch.int32, device=dev)
        got = mx_decode_attention(*on_dev, pos_d, **kw)
        assert torch.equal(got, mx_decode_attention(*on_dev, pos, **kw))
        want = mx_decode_attention(q, *args[1:], pos, **kw)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want, rtol=2e-5,
                                       atol=2e-5)
        else:
            torch.testing.assert_close(got.cpu(), want)


_BAD_POS_SCRIPT = """
import sys, torch
from repro_torch.core.spec import QuantSpec
from repro_torch.kernels.mx_kv_write import mx_cache_kv_write
from repro_torch.serve.graphs import CapturedStep
kk = QuantSpec.parse("int8@32:ocp")
cache = {{n: torch.zeros(2, 8, 2, w, dtype=torch.uint8, device="cuda")
         for n, w in (("k_codes", 64), ("k_scales", 2), ("v_codes", 64),
                      ("v_scales", 2))}}
k = torch.ones(2, 1, 2, 64, device="cuda")
pos = torch.zeros(1, dtype=torch.int32, device="cuda")
step = CapturedStep(lambda: mx_cache_kv_write(cache, k, k, pos, kk, kk),
                    torch.device("cuda"))
step()
torch.cuda.synchronize()
pos.fill_({pos})
try:
    step()
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("pos", [8, -1])
def test_kv_write_trap_surfaces_from_a_replay(dev, pos):
    """A device pos outside the cache makes the KV write trap inside a
    graph replay, and the next synchronizing call raises, as an eager
    launch's would (in a child process: a trap spoils the context)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run(
        [sys.executable, "-c", _BAD_POS_SCRIPT.format(pos=pos)],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, (run.stdout, run.stderr[-2000:])


_HOST_SYNC_SCRIPT = """
import sys, torch
from repro_torch.serve.graphs import CapturedStep
x = torch.ones(4, device="cuda")
try:
    CapturedStep(lambda: x.add_(float(x.sum())), torch.device("cuda"))
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
sys.exit(1)
"""


def test_capture_failure_raises(dev):
    """A step that waits for the host cannot be captured: building the
    graph raises, and nothing falls back to an eager run (in a child
    process: a failed capture may leave the context unusable)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run([sys.executable, "-c", _HOST_SYNC_SCRIPT],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, (run.stdout, run.stderr[-2000:])


def _full_width_2_layers(dev, policy=POLICY):
    """Full-width chatglm3-6b cut to 2 layers, MX weights, on the card,
    attention through the kernels (``attn_impl="flash"``)."""
    from repro_torch.launch.serve import build_model
    return build_model("chatglm3_6b", reduced=False, quant=policy,
                       weight_resident=True, device=str(dev), seed=0,
                       n_layers=2, attn_impl="flash")


def _prompts(vocab, n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, size=n)]


def _serve_all(eng, prompts, new):
    rids = [eng.add_request(p, new) for p in prompts]
    out = eng.run()
    return [out[r].tolist() for r in rids]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graph_window_matches_eager(dev, temperature):
    """One window of the continuous engine (replays of its captured step)
    against ``paged_decode_multi_step`` eagerly from the same state:
    identical tokens, lengths, budgets, keys and flags; byte-identical
    pools (page 0, the trash page the capture's warm-up writes, left
    out).  One replay credits 7 matmul, 1 KV-write and 1 paged-attention
    launch per layer."""
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    from repro_torch.serve.paging import TRASH_PAGE
    model, params = _full_width_2_layers(dev)
    eng = ContinuousBatchingEngine(
        model, params, max_slots=4, page_size=16, max_len=200, sync_every=8,
        prefill_bucket=64, gen=GenerationConfig(temperature=temperature))
    assert {w.__name__: n for w, n in eng.window.step.launches.items()} \
        == {"mx_matmul_2d": 14, "mx_paged_kv_write": 2,
            "mx_paged_decode_attention": 2}
    for p in _prompts(model.cfg.vocab, 4, 20, 150):
        eng.add_request(p, 24)
    eng.step()
    window = eng.scheduler.plan_window(eng._lengths, eng.sync_every)
    eng._upload_tables()
    w = eng.window
    state = [torch.from_numpy(a.copy()).to(dev)
             for a in (eng._cur_tok, eng._lengths, eng._remaining)]
    pool = {k: v.clone() for k, v in eng.pool.items()}
    toks, pool, lengths, remaining, keys, bad = \
        model.paged_decode_multi_step(
            params, state[0], pool, w.block_tables.clone(), state[1],
            state[2], w.keys.clone(), n_steps=window,
            temperature=temperature, trash_page=TRASH_PAGE, health=True)
    eng.step()
    assert torch.equal(w.tokens[:window], toks)
    assert torch.equal(w.state[1], lengths)
    assert torch.equal(w.state[2], remaining)
    assert torch.equal(w.keys, keys) and torch.equal(w.bad, bad)
    for k in pool:
        assert torch.equal(eng.pool[k][:, 1:], pool[k][:, 1:]), k


def test_sync_every_gives_identical_sampled_tokens(dev):
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    model, params = _full_width_2_layers(dev)
    prompts = _prompts(model.cfg.vocab, 6, 10, 90, seed=1)
    outs = []
    for se in (1, 8):
        eng = ContinuousBatchingEngine(
            model, params, max_slots=4, page_size=16, max_len=120,
            sync_every=se, prefill_bucket=32,
            gen=GenerationConfig(temperature=0.8, seed=2))
        outs.append(_serve_all(eng, prompts, 12))
    assert outs[0] == outs[1]


def test_static_graph_matches_eager_and_continuous(dev):
    """The static engine's replayed step (pos on the device) gives the
    eager loop's tokens (``decode_step`` at host positions) and the
    continuous engine's; the second call replays the first call's graph;
    one replay credits 7 matmul, 1 KV-write and 1 decode-attention launch
    per layer."""
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   GenerationConfig, ServeEngine)
    model, params = _full_width_2_layers(dev)
    vocab = model.cfg.vocab
    tokens = np.random.default_rng(3).integers(0, vocab, size=(4, 100))
    tokens = tokens.astype(np.int32)
    eng = ServeEngine(model, params, max_len=120)
    gen = GenerationConfig(max_new_tokens=12)
    first = eng.generate({"tokens": tokens}, gen)
    again = eng.generate({"tokens": tokens}, gen)
    assert eng.n_captures == 1 and np.array_equal(first, again)
    graph = eng._graphs[(4, 0.0)]
    assert {w.__name__: n for w, n in graph.step.launches.items()} \
        == {"mx_matmul_2d": 14, "mx_cache_kv_write": 2,
            "mx_decode_attention": 2}
    logits, cache, pos = model.prefill(
        params, torch.from_numpy(tokens).to(dev), max_len=120)
    tok = torch.argmax(logits[:, -1, :vocab], -1).to(torch.int32)
    eager = [tok]
    for i in range(11):
        lg, cache = model.decode_step(params, tok, cache, pos + i)
        tok = torch.argmax(lg[:, -1, :vocab], -1).to(torch.int32)
        eager.append(tok)
    assert np.array_equal(first, torch.stack(eager, 1).cpu().numpy())
    cont = ContinuousBatchingEngine(model, params, max_slots=4,
                                    page_size=16, max_len=120,
                                    prefill_bucket=32)
    assert _serve_all(cont, list(tokens), 12) == first.tolist()


def test_quarantine_on_card(dev):
    """A prompt holding a token whose embedding row is NaN is quarantined
    at admission; its neighbour gets its solo tokens."""
    from repro_torch.serve import ContinuousBatchingEngine
    model, params = _full_width_2_layers(dev)
    params = dict(params, embed=params["embed"].clone())
    params["embed"][7] = float("nan")
    healthy, poisoned = _prompts(model.cfg.vocab, 2, 30, 60, seed=4)
    healthy = healthy[healthy != 7]
    poisoned[5] = 7

    def engine():
        return ContinuousBatchingEngine(model, params, max_slots=4,
                                        page_size=16, max_len=80,
                                        prefill_bucket=32)

    solo = engine()
    want = _serve_all(solo, [healthy], 10)[0]
    eng = engine()
    rh, rp = eng.add_request(healthy, 10), eng.add_request(poisoned, 10)
    out = eng.run()
    assert [r.rid for r in eng.scheduler.failed] == [rp]
    assert "health guard" in eng.scheduler.failed[0].error
    assert eng.n_quarantined == 1 and out[rh].tolist() == want


def test_attribute_calls_are_accepted_during_capture(dev):
    """Kernels whose wrappers call ``cudaFuncSetAttribute`` on every launch
    (f32 flash; f32 contiguous decode attention above 48 KB of shared
    memory, here rep 32 at D 128) capture and replay: the call is made
    while the capture is open, and a replay gives the eager call's bits."""
    from repro_torch.serve.graphs import CapturedStep
    rng = np.random.default_rng(23)
    args, kw = _bf16_contiguous(rng, 32, 1, 128, b=2)
    q = args[0].float().to(dev)
    cache = [t.to(dev) for t in args[1:]]
    x = torch.from_numpy(rng.normal(size=(1, 64, 4, 128)).astype(
        np.float32)).to(dev)
    out = {}

    def step():
        out["attn"] = mx_decode_attention(q, *cache, 300, **kw)
        out["flash"] = flash_attention(x, x, x, causal=True)

    graph = CapturedStep(step, dev)
    assert graph.graph is not None
    graph()
    torch.cuda.synchronize()
    assert torch.equal(out["attn"], mx_decode_attention(q, *cache, 300,
                                                        **kw))
    assert torch.equal(out["flash"], flash_attention(x, x, x, causal=True))


# =============================================================================
# preempt-and-swap and snapshots on the card
# =============================================================================
def test_swap_round_trip_on_card(dev):
    """Pages of a CUDA pool gather into pinned host tensors (byte-equal to
    the pool's pages) and scatter back, in place, onto other pages; a
    concatenation of pinned copies stays pinned."""
    from repro_torch.serve.swap import (concat_snapshots, gather_pages,
                                        scatter_pages)
    g = torch.Generator(device=dev).manual_seed(0)
    pool = {"kc": torch.randint(0, 256, (3, 9, 16, 2, 128), generator=g,
                                dtype=torch.uint8, device=dev),
            "vs": torch.randn((3, 9, 16, 2, 4), generator=g, device=dev)
            .to(torch.bfloat16)}
    a, na = gather_pages(pool, [2, 7])
    b, nb = gather_pages(pool, [4])
    for k, leaf in pool.items():
        assert a[k].device.type == "cpu" and a[k].is_pinned()
        assert torch.equal(a[k], leaf[:, [2, 7]].cpu())
    assert na == 2 * nb == sum(t.numel() * t.element_size()
                               for t in a.values())
    both = concat_snapshots([a, b])
    assert all(t.is_pinned() for t in both.values())
    leaves = {k: v for k, v in pool.items()}
    ptrs = {k: v.data_ptr() for k, v in pool.items()}
    scatter_pages(pool, [1, 3, 5], both)
    torch.cuda.synchronize()
    for k, leaf in pool.items():
        assert leaf is leaves[k] and leaf.data_ptr() == ptrs[k]
        assert torch.equal(leaf[:, [1, 3, 5]].cpu(),
                           torch.cat([a[k], b[k]], dim=1))


def _slo_script(eng, vocab, temperature=0.0):
    """A batch-class request decodes; an interactive one arrives that a
    tight pool cannot hold beside it.  Returns {rid: tokens}."""
    rng = np.random.default_rng(3)
    pb = rng.integers(1, vocab, size=40).astype(np.int32)
    pa = rng.integers(1, vocab, size=50).astype(np.int32)
    rb = eng.add_request(pb, 60, priority=1)
    req = eng.scheduler.waiting[0]
    while len(req.out) < 9:
        eng.step()
    ra = eng.add_request(pa, 8, priority=0)
    out = eng.run()
    return {r: out[r].tolist() for r in (rb, ra)}


def _arm_eager_check(eng, model, params, temperature, seen):
    """Make the engine's next decode window also run eagerly
    (``paged_decode_multi_step`` on clones of the same state) before its
    replays, and hold the two equal: tokens, state, keys, flags, and the
    pool but for the trash page."""
    from repro_torch.serve.paging import TRASH_PAGE
    w = eng.window
    run = w.run

    def checked(n):
        w.run = run
        state = w.state.clone()
        pool = {k: v.clone() for k, v in eng.pool.items()}
        toks, pool, lengths, remaining, keys, bad = \
            model.paged_decode_multi_step(
                params, state[0], pool, w.block_tables.clone(), state[1],
                state[2], w.keys.clone(), n_steps=n,
                temperature=temperature, trash_page=TRASH_PAGE, health=True)
        run(n)
        assert torch.equal(w.tokens[:n], toks)
        assert torch.equal(w.state[1], lengths)
        assert torch.equal(w.state[2], remaining)
        assert torch.equal(w.keys, keys) and torch.equal(w.bad, bad)
        for k in pool:
            assert torch.equal(eng.pool[k][:, 1:], pool[k][:, 1:]), k
        seen.append(n)

    w.run = checked


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("widths", ["reduced", "full-width-2-layers"])
def test_preempt_identity_with_graph_replay(dev, widths, temperature):
    """The reduced config (f32, head dim 32) and two full-width layers:
    over a tight pool the batch request is swapped to pinned host memory
    and restored into the pool the captured graph reads; the window after
    the restore, replayed, equals the eager loop from the same state, and
    the tokens equal a large pool's."""
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    if widths == "reduced":
        model, params = build_model("chatglm3_6b", reduced=True,
                                    quant=POLICY, weight_resident=True,
                                    device=str(dev), seed=0,
                                    attn_impl="flash")
    else:
        model, params = _full_width_2_layers(dev)

    def engine(num_pages):
        return ContinuousBatchingEngine(
            model, params, max_slots=2, page_size=16, max_len=112,
            num_pages=num_pages, sync_every=8, prefill_bucket=32,
            preempt=True, gen=GenerationConfig(temperature=temperature))

    tight, seen = engine(10), []
    restore = tight._restore_swapped

    def restored(reqs):
        restore(reqs)
        _arm_eager_check(tight, model, params, temperature, seen)

    tight._restore_swapped = restored
    got = _slo_script(tight, model.cfg.vocab)
    assert tight.n_preemptions == tight.n_restores == 1 and seen
    assert tight.swap_store.bytes_in == tight.swap_store.bytes_out > 0
    large = engine(32)
    assert _slo_script(large, model.cfg.vocab) == got
    assert large.n_preemptions == 0


def test_snapshot_restore_then_replay_matches_eager(dev):
    """Capture mid-stream, run on, restore: the pool and keys go back into
    the tensors the captured graph reads, the next replayed window equals
    the eager loop, and the tokens are those of the first continuation."""
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   GenerationConfig, capture, restore)
    model, params = _full_width_2_layers(dev)
    eng = ContinuousBatchingEngine(
        model, params, max_slots=4, page_size=16, max_len=100,
        sync_every=8, prefill_bucket=32,
        gen=GenerationConfig(temperature=0.8))
    rids = [eng.add_request(p, 24)
            for p in _prompts(model.cfg.vocab, 4, 20, 70, seed=6)]
    eng.step()
    pool = {k: v.data_ptr() for k, v in eng.pool.items()}
    snap = capture(eng)
    want = eng.run()
    restore(eng, snap)
    assert {k: v.data_ptr() for k, v in eng.pool.items()} == pool
    seen = []
    _arm_eager_check(eng, model, params, 0.8, seen)
    got = eng.run()
    assert seen and all(np.array_equal(got[r], want[r]) for r in rids)


@pytest.mark.parametrize("use_executor", [False, True])
def test_async_server_on_card(dev, use_executor):
    """Streams through AsyncServer (the step on the loop, or in an
    executor thread, which enters the engine's device) equal the
    synchronous engine's tokens on the card."""
    import asyncio
    from repro_torch.serve import AsyncServer, ContinuousBatchingEngine
    model, params = _full_width_2_layers(dev)
    prompts = _prompts(model.cfg.vocab, 5, 10, 60, seed=8)

    def engine():
        return ContinuousBatchingEngine(model, params, max_slots=2,
                                        page_size=16, max_len=80,
                                        sync_every=4, prefill_bucket=32,
                                        preempt=True)

    want = _serve_all(engine(), prompts, 10)

    async def go():
        async with AsyncServer(engine(), use_executor=use_executor) as srv:
            streams = [await srv.submit(p, 10, priority=i % 2)
                       for i, p in enumerate(prompts)]
            return [(await s.tokens()).tolist() for s in streams]

    assert asyncio.run(asyncio.wait_for(go(), 300)) == want


@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_bf16_head_dim_96(dev, paged):
    """bf16 q at head dim 96 (a multiple of 32 the tensor-core kernels are
    not built for) runs the CUDA-core kernel on an f32 copy of q: one
    launch, a bf16 output within torch's bf16 defaults of the plain
    version."""
    kspec, vspec = (QuantSpec.parse(s) for s in ("int8@32:ocp",
                                                 "e2m1@32:ocp"))
    rng = np.random.default_rng(96)
    if paged:
        args, kw = _bf16_paged(rng, kspec, vspec, rep=16, hkv=2, d=96)
        fn = mx_paged_decode_attention
        calls = [args]
    else:
        args, kw = _bf16_contiguous(rng, 16, 2, 96)
        fn = mx_decode_attention
        calls = [args + [pos] for pos in (0, 63, 64, 575, 639)]
    for call in calls:
        want = fn(*call, **kw)
        before = fn.launches
        got = fn(*(t.to(dev) if torch.is_tensor(t) else t for t in call),
                 **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.cpu(), want)


def test_poison_written_in_place_is_seen_by_the_next_replay(dev):
    """A ``page_corrupt`` fault writes SCALE_NAN into the live pool the
    captured decode graph reads: the next replayed window flags exactly
    the target, which is quarantined with its pages scrubbed, and the
    other requests keep the tokens of a clean run."""
    from repro_torch.serve import ContinuousBatchingEngine, FaultPlan
    model, params = _full_width_2_layers(dev)
    prompts = _prompts(model.cfg.vocab, 3, 20, 60, seed=6)

    def engine(plan=None):
        return ContinuousBatchingEngine(model, params, max_slots=4,
                                        page_size=16, max_len=100,
                                        sync_every=4, prefill_bucket=32,
                                        faults=plan)

    clean = engine()
    want = dict(zip(range(3), _serve_all(clean, prompts, 16)))
    plan = FaultPlan.parse("page_corrupt:nth=1:rid=1", seed=2)
    eng = engine(plan)
    scrubbed = []
    quarantine = eng._quarantine

    def watched(req, diag):
        ids = eng.blocks.slot_page_ids(req.slot)
        quarantine(req, diag)
        dead = [i for i in ids if eng.blocks.page_refcount(i) == 0]
        # zeros as they return to the free list (a later grant reuses them)
        scrubbed.append(all(not leaf[:, dead].any()
                            for leaf in eng.pool.values()) and bool(dead))

    eng._quarantine = watched
    rids = [eng.add_request(p, 16) for p in prompts]
    out = eng.run()
    assert plan.fired == [("page_corrupt", None, 1)]
    assert [r.rid for r in eng.scheduler.failed] == [1]
    assert scrubbed == [True]
    for r in rids:
        if r != 1:
            assert out[r].tolist() == want[r], r


def test_watchdog_recovers_a_stalled_step_on_card(dev):
    """``AsyncServer(use_executor=True, watchdog_s=5)`` cuts a 60 s
    injected stall, restores the last snapshot into the pool the graph
    reads, and every stream ends with the clean run's tokens."""
    import asyncio
    import time
    from repro_torch.serve import (AsyncServer, ContinuousBatchingEngine,
                                   FaultPlan)
    model, params = _full_width_2_layers(dev)
    prompts = _prompts(model.cfg.vocab, 3, 20, 60, seed=7)

    def engine(plan=None):
        return ContinuousBatchingEngine(model, params, max_slots=4,
                                        page_size=16, max_len=100,
                                        sync_every=4, prefill_bucket=32,
                                        faults=plan)

    want = _serve_all(engine(), prompts, 16)
    plan = FaultPlan.parse("stall:nth=2:stall_s=60", seed=13)
    eng = engine(plan)

    async def go():
        async with AsyncServer(eng, use_executor=True, watchdog_s=5.0,
                               snapshot_every=1) as srv:
            streams = [await srv.submit(p, 16) for p in prompts]
            return srv, [(await s.tokens()).tolist() for s in streams]

    t0 = time.perf_counter()
    srv, got = asyncio.run(asyncio.wait_for(go(), 120))
    assert time.perf_counter() - t0 < 40
    assert srv.n_recoveries >= 1 and ("stall", None, 2) in plan.fired
    assert got == want


# a per-layer table: layer 1 at packed e2m1 weights and its own KV formats
MIXED_TABLE = (POLICY, {1: "weights=e2m1@32:ocp,kv_key=e3m2@32:ocp,"
                           "kv_value=e2m3@32:ocp"})


def test_policy_table_window_matches_eager_on_card(dev):
    """Two full-width layers under a table that mixes weight and KV
    formats by layer: one replay credits 7 matmul, 1 KV-write and 1
    paged-attention launch per layer, by spec each layer's own formats
    (and a run's launches by spec add up to its launches), each layer's
    pool is sized by its own specs, and the first window after admission,
    replayed, equals the eager loop (tokens, state, keys, flags, pools)."""
    from repro_torch.core.spec import PolicyTable
    from repro_torch.kernels.mx_decode_attn import mx_paged_decode_attention
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import ContinuousBatchingEngine
    from repro_torch.serve.paging import kv_token_nbytes
    model, params = build_model(
        "chatglm3_6b", reduced=False, quant=None, weight_resident=True,
        device=str(dev), seed=0, n_layers=2, attn_impl="flash",
        table=PolicyTable(*MIXED_TABLE))
    cfg = model.cfg
    assert [lp["mlp"]["w1"].fmt for lp in params["layers"]] \
        == ["e4m3", "e2m1"]
    eng = ContinuousBatchingEngine(model, params, max_slots=4, page_size=16,
                                   max_len=200, sync_every=8,
                                   prefill_bucket=64)
    assert {w.__name__: n for w, n in eng.window.step.launches.items()} \
        == {"mx_matmul_2d": 14, "mx_paged_kv_write": 2,
            "mx_paged_decode_attention": 2}
    by_spec = eng.window.step.spec_launches
    assert {str(k): n for k, n in by_spec[mx_matmul_2d].items()} \
        == {"e4m3@32:ocp+unpacked": 7, "e2m1@32:ocp": 7}
    assert {f"{k}/{v}": n
            for (k, v), n in by_spec[mx_paged_decode_attention].items()} \
        == {"int8@32:ocp/e2m1@32:ocp": 1, "e3m2@32:ocp/e2m3@32:ocp": 1}
    assert eng.kv_pool_layer_nbytes == [
        16 * eng.blocks.num_pages * kv_token_nbytes(
            cfg.layer_policy(i), cfg.n_kv_heads, cfg.hd)
        for i in range(2)]
    seen = []
    _arm_eager_check(eng, model, params, 0.0, seen)
    was = [(w.launches, dict(w.launches_by_spec))
           for w in (mx_matmul_2d, mx_paged_decode_attention)]
    out = _serve_all(eng, _prompts(cfg.vocab, 4, 20, 150, seed=3), 16)
    assert seen and all(len(o) == 16 for o in out)
    for w, (n0, by0) in zip((mx_matmul_2d, mx_paged_decode_attention), was):
        assert sum(w.launches_by_spec.values()) - sum(by0.values()) \
            == w.launches - n0 > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_vjp_backward_matches_plain_autograd(dev, dtype):
    """``flash_attention_vjp`` forward launches the flash kernel (within
    its tolerance of the plain version); its backward, a dense recompute,
    equals plain autograd through ``flash_attention_ref`` bit for bit."""
    from repro_torch.kernels.flash_attn import flash_attention_vjp
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
               for shape in ((2, 70, 8, 128), (2, 70, 2, 128),
                             (2, 70, 2, 128)))
    g = torch.randn((2, 70, 8, 128), generator=gen, device=dev, dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention_vjp(*leaves, causal=True)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = ref.flash_attention_ref(*plain, causal=True)
    want = torch.autograd.grad(want_out, plain, g)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, want_out, rtol=tol, atol=tol)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(8, 512, 2, 128), (3, 77, 40)])
def test_tensor_reduction_on_card_matches_cpu(dev, shape):
    """The calibration reduction of one tensor on the card and on the
    CPU: counts, the exponent histogram, absmax and the sample exactly;
    the sums within 1e-5 relative (another summation order; a mean of
    0.5 keeps the sum away from cancellation)."""
    from repro_torch.calib.stats import _to_stats, tensor_reduction
    rng = np.random.default_rng(9)
    x = (rng.normal(size=shape) + 0.5).astype(np.float32)
    x.reshape(-1)[::13] = 0.0
    x.reshape(-1)[5::97] *= np.float32(1e-39)        # f32 subnormals
    x = torch.from_numpy(x)
    card = _to_stats(tensor_reduction(x.to(dev)))
    cpu = _to_stats(tensor_reduction(x))
    assert (card.count, card.n_zero, card.absmax) \
        == (cpu.count, cpu.n_zero, cpu.absmax)
    np.testing.assert_array_equal(card.exp_hist, cpu.exp_hist)
    np.testing.assert_array_equal(card.sample, cpu.sample)
    np.testing.assert_allclose(card.total, cpu.total, rtol=1e-5)
    np.testing.assert_allclose(card.sumsq, cpu.sumsq, rtol=1e-5)


TRAIN_QUANT = "weights=e4m3@32:ocp,activations=e4m3@32:ocp"


@pytest.mark.parametrize("fmt", ["e4m3", "e2m1", "e2m3", "int8"])
def test_fake_quant_route_matches_plain_round_trip(dev, fmt):
    """QAT fake quantization on the card (``ops.fake_quantize``: the
    converter kernel, then the port's dequantize) against the plain round
    trip (``core.convert``, on the CPU) at every weight shape of a
    chatglm3-6b layer along K: values bit for bit (NaN and Inf blocks
    included), and one converter launch per call."""
    from repro_torch.core import convert
    from repro_torch.kernels.ops import fake_quantize
    rng = np.random.default_rng(5)
    spec = QuantSpec(fmt, "ocp")
    for k, n in ((4096, 4096), (4096, 256), (4096, 13696), (13696, 4096)):
        w = rng.normal(size=(k, n)).astype(np.float32) * 0.016
        w[3, 9], w[40, 1], w[99, 2] = np.nan, np.inf, -np.inf
        w = torch.from_numpy(w)
        before = mx_quantize_2d.launches
        got = fake_quantize(w.to(dev), spec, axis=0)
        assert mx_quantize_2d.launches == before + 1
        want = convert.quantize_dequantize(w, spec, axis=0)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


def _reduced_train(device, quant=TRAIN_QUANT, remat=True):
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model, load_reduced
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_map
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(quant),
                       attn_impl="flash", remat=remat)
    params, _ = init_train_state(Model(cfg, "cpu"), seed=0)
    params = tree_map(lambda t: t.to(device), params)
    model = Model(cfg, device)
    step = build_train_step(model, AdamWConfig(lr=2e-3, warmup_steps=1,
                                               total_steps=3),
                            fake_quant=quant != "none")
    return model, params, adamw_init(params), step


def test_reduced_qat_on_card_matches_cpu(dev):
    """Three QAT steps (weights + activations, remat on) of the reduced
    chatglm3-6b (f32) from the same params on the card and on the CPU:
    losses and grad norms within rtol 1e-4, masters within the
    reference's rtol 2e-3, atol 2e-5 (f32 sums in other orders)."""
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.tree import leaves
    runs = []
    for device in (dev, "cpu"):
        model, params, opt, step = _reduced_train(device)
        data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=32,
                                      global_batch=8, seed=3))
        mets = []
        for i in range(3):
            params, opt, met = step(params, opt, make_batch_for(
                model.cfg, data.batch(i), device=device), i)
            mets.append((float(met["loss"]), float(met["grad_norm"])))
        runs.append((mets, [t.cpu() for t in leaves(opt["master"])]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_train_grads_on_card_match_cpu(dev, dtype, rtol):
    """Every leaf's gradient (``_grads_of``) and, after one step from zero
    moments, its ``m`` on the card against the CPU, reduced chatglm3-6b
    with no quant and remat on, within ``rtol`` in relative L2 norm, and
    loss and grad norm within it.  f32: sums in other orders.  bf16: each
    product rounds its output to bf16 on both devices where the f32 sums
    before it differ, and the card's LM head (``_HeadMM``) rounds the
    logits' gradient to bf16 (ROADMAP C10): a few ulps of bf16."""
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.models import Model, load_reduced
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.train.step import _grads_of
    from repro_torch.tree import leaves, tree_map
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse("none"),
                       attn_impl="flash", remat=True, dtype=dtype,
                       param_dtype=dtype)
    start = Model(cfg, "cpu").init(seed=0)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=3))
    runs = []
    for device in (dev, "cpu"):
        model = Model(cfg, device)
        params = tree_map(lambda t: t.to(device, copy=True), start)
        batch = make_batch_for(cfg, data.batch(0), device=device)
        loss, _, grads = _grads_of(model, params, batch, False)
        step = build_train_step(model, AdamWConfig(lr=2e-3, warmup_steps=1,
                                                   total_steps=3))
        _, opt, met = step(params, adamw_init(params), batch, 0)
        runs.append(([float(loss), float(met["loss"]),
                      float(met["grad_norm"])],
                     [g.cpu().float() for g in leaves(grads)],
                     [m.cpu() for m in leaves(opt["m"])]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=rtol)
    for k in (1, 2):
        for a, b in zip(runs[0][k], runs[1][k]):
            assert float((a - b).norm()) <= rtol * float(b.norm())


def test_train_resume_on_card_is_bit_identical(dev, tmp_path):
    """Six steps of weights-only QAT through ``train_loop`` on the card
    (flash, remat, the converter in each forward and recompute), and a
    run cut at a checkpoint at step 3 and resumed in a fresh state:
    params and the AdamW state equal bit for bit."""
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.train import LoopConfig, train_loop
    from repro_torch.tree import leaves
    quant = "weights=e4m3@32:ocp"
    model, _, _, step = _reduced_train(dev, quant)
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=32,
                                  global_batch=8, seed=3))

    def run(total, d, every):
        _, p, o, _ = _reduced_train(dev, quant)
        return train_loop(LoopConfig(total_steps=total, ckpt_dir=str(d),
                                     ckpt_every=every, log_every=100),
                          step, p, o, lambda i: make_batch_for(
                              model.cfg, data.batch(i), device=dev),
                          log=lambda *_: None)

    a = run(6, tmp_path / "a", 0)
    run(3, tmp_path / "b", 3)
    b = run(6, tmp_path / "b", 0)
    assert [h["loss"] for h in b["history"]] == [
        h["loss"] for h in a["history"]][3:]
    for x, y in zip(leaves({"p": a["params"], "o": a["opt"]}),
                    leaves({"p": b["params"], "o": b["opt"]})):
        assert torch.equal(x, y)


# =============================================================================
# the other families: MLA, the patch frontend, the hybrid, RWKV6, enc-dec
# =============================================================================
def test_matmul_bf16_at_internvl2_w1(dev):
    """internvl2-76b's w1 shape (K 8192, N 28672) at a decode batch of 8,
    bf16 activations, e4m3, against the plain version on the card;
    rtol/atol 1e-5 relative to the output scale, as above."""
    rng = np.random.default_rng(24)
    k, n = 8192, 28672
    a = torch.from_numpy(rng.normal(size=(8, k)).astype(np.float32))
    w = torch.randn(k, n, device=dev) / np.sqrt(k)
    mw = MXWeight.quantize(w, QuantSpec.parse("e4m3@32:ocp"))
    del w
    a = a.to(dev).to(torch.bfloat16)
    got = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
    want = ref.mx_matmul_2d_ref(a, mw.codes, mw.scales, mw.spec)
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("width", [512, 64])
def test_converter_on_mla_rows_bit_identical(dev, width):
    """MLA's compressed cache rows (c_kv 512, k_rope 64), a decode step's
    8 and a prefill's 4096, INT8 and E4M3, special values in: codes and
    scales bit for bit the plain converter's; and the layer's cache
    write on the card, at a device position, equals its CPU run."""
    from repro_torch.models import layers as L
    from repro_torch.models import load_reduced
    rng = np.random.default_rng(width)
    for spec in ("int8@32:ocp", "e4m3@32:ocp"):
        spec = QuantSpec.parse(spec)
        for m in (8, 4096):
            x = rng.normal(size=(m, width)).astype(np.float32)
            x[:8] = _special_rows(rng, width)
            x = torch.from_numpy(x)
            c, sc = mx_quantize_2d(x.to(dev), spec)
            rc, rs = mx_quantize_2d(x, spec)
            torch.cuda.synchronize()
            assert torch.equal(c.cpu(), rc) and torch.equal(sc.cpu(), rs)
    cfg = load_reduced("deepseek_v2_236b", mx=QuantPolicy.parse(
        "kv=int8@32:ocp"), kv_lora=512, qk_rope_dim=64)
    ckv = torch.from_numpy(rng.normal(size=(3, 1, 512)).astype(np.float32))
    kr = torch.from_numpy(rng.normal(size=(3, 1, 64)).astype(np.float32))
    caches = []
    for d, pos in ((torch.device("cpu"), 5),
                   (dev, torch.tensor([5], dtype=torch.int32, device=dev))):
        cache = L.init_mla_cache(cfg, 3, 8, d)
        L._mla_cache_write(cache, ckv.to(d), kr.to(d), pos, cfg)
        caches.append({k: v.cpu() for k, v in cache.items()})
    assert all(torch.equal(caches[0][k], caches[1][k]) for k in caches[0])
    assert caches[0]["ckv_codes"][:, 5].any()


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_7b",
                                  "seamless_m4t_medium", "deepseek_v2_236b",
                                  "internvl2_76b"])
def test_captured_family_step_matches_eager(dev, arch):
    """The reduced config in bf16 under INT8 K / E2M1 V at
    ``attn_impl="flash"`` (internvl2 weight-resident e4m3) through
    ``ServeEngine`` on the card: the captured decode step, replayed once
    per token, gives the eager loop's tokens, and the graph's cache and
    recurrent states after the run are byte-identical to the eager
    loop's (KV caches, Mamba2 conv / ssm states, RWKV shift and WKV
    states, the cross K/V, MLA's compressed cache); a second call gives
    the same tokens."""
    from repro_torch.launch.serve import build_model
    from repro_torch.models import make_concrete_batch
    from repro_torch.serve import GenerationConfig, ServeEngine
    resident = arch == "internvl2_76b"
    quant = ("weights=e4m3@32:ocp," if resident else "") \
        + "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
    model, params = build_model(arch, reduced=True, quant=quant,
                                weight_resident=resident, device=str(dev),
                                seed=0, attn_impl="flash",
                                dtype="bfloat16")
    batch = make_concrete_batch(model.cfg, 3, 40, seed=2)
    batch.pop("labels")
    new, max_len = 9, 64
    eng = ServeEngine(model, params, max_len=max_len)
    gen = GenerationConfig(max_new_tokens=new)
    first = eng.generate(batch, gen)
    again = eng.generate(batch, gen)
    assert eng.n_captures == 1 and np.array_equal(first, again)
    graph = next(iter(eng._graphs.values()))
    vocab = model.cfg.vocab
    logits, cache, pos = model.prefill(params, batch, max_len=max_len)
    tok = torch.argmax(logits[:, -1, :vocab], -1).to(torch.int32)
    eager = [tok]
    for i in range(new - 1):
        lg, cache = model.decode_step(params, tok, cache, pos + i)
        tok = torch.argmax(lg[:, -1, :vocab], -1).to(torch.int32)
        eager.append(tok)
    torch.cuda.synchronize()
    assert np.array_equal(first, torch.stack(eager, 1).cpu().numpy())
    got, want = list(_leaves(graph.cache)), list(_leaves(cache))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _family_train(arch, device, quant="none", dtype="float32", seed=0):
    """Reduced ``arch`` (flash, remat on) on ``device`` from params made
    on the CPU from ``seed``, and its train step."""
    from repro_torch.models import Model, load_reduced
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.tree import tree_map
    cfg = load_reduced(arch, mx=QuantPolicy.parse(quant), attn_impl="flash",
                       remat=True, dtype=dtype, param_dtype=dtype)
    params = tree_map(lambda t: t.to(device),
                      Model(cfg, "cpu").init(seed=seed))
    model = Model(cfg, device)
    step = build_train_step(model, AdamWConfig(lr=2e-3, warmup_steps=1,
                                               total_steps=3),
                            fake_quant=quant != "none")
    return model, params, adamw_init(params), step


@pytest.mark.parametrize("quant,steps", [("none", 3),
                                         ("weights=e4m3@32:ocp", 1)])
@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_7b"])
def test_family_train_on_card_matches_cpu(dev, arch, quant, steps):
    """Train steps of the reduced hybrid and RWKV6 (f32, remat on, the
    chunked scans' backward through autograd) from the same params on
    the card and on the CPU: losses and grad norms within rtol 1e-4,
    masters within the reference's rtol 2e-3, atol 2e-5 (f32 sums in
    other orders).  Under fake-quantized weights one step: from the same
    weights both devices take the same codes, but after a step the
    weights differ by rounding noise, and a weight at a rounding boundary
    takes the neighbouring code on one device."""
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.tree import leaves
    runs = []
    for device in (dev, "cpu"):
        model, params, opt, step = _family_train(arch, device, quant)
        data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=48,
                                      global_batch=4, seed=3))
        mets = []
        for i in range(steps):
            params, opt, met = step(params, opt, make_batch_for(
                model.cfg, data.batch(i), device=device), i)
            mets.append((float(met["loss"]), float(met["grad_norm"])))
        runs.append((mets, [t.cpu() for t in leaves(opt["master"])]))
    assert np.isfinite(runs[0][0]).all()
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)


def _family_grads_and_m(arch, device, dtype, params=None):
    """Loss, grad norm, every leaf's gradient and, after one step from
    zero moments, its ``m`` (f32, on the CPU) of the reduced ``arch`` in
    ``dtype`` (no quant, remat on) on ``device``; from ``params`` when
    given, else from seed 0."""
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import _grads_of
    from repro_torch.tree import leaves, tree_map
    model, p, opt, step = _family_train(arch, device, dtype=dtype)
    if params is not None:
        p = tree_map(lambda t: t.to(device, copy=True), params)
        opt = adamw_init(p)
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=48,
                                  global_batch=4, seed=3))
    batch = make_batch_for(model.cfg, data.batch(0), device=device)
    loss, _, grads = _grads_of(model, p, batch, False)
    assert all(g is not None for g in leaves(grads))
    grads = [g.cpu().float() for g in leaves(grads)]
    _, opt, met = step(p, opt, batch, 0)
    return ([float(loss), float(met["loss"]), float(met["grad_norm"])],
            grads, [m.cpu() for m in leaves(opt["m"])])


@pytest.mark.parametrize("arch,dtype,rtol", [
    ("zamba2_1p2b", "float32", 1e-4), ("rwkv6_7b", "float32", 1e-4),
    ("rwkv6_7b", "bfloat16", 3e-2)])
def test_family_train_grads_on_card_match_cpu(dev, arch, dtype, rtol):
    """Every leaf's gradient and, after one step from zero moments, its
    ``m`` on the card against the CPU, reduced hybrid and RWKV6 with no
    quant and remat on, within ``rtol`` in relative L2 norm (the
    tolerances of ``test_train_grads_on_card_match_cpu``); every leaf
    has a gradient on both devices.  The hybrid in bf16 is
    ``test_hybrid_bf16_grads_on_card_held_to_f32``."""
    runs = [_family_grads_and_m(arch, device, dtype)
            for device in (dev, "cpu")]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=rtol)
    for k in (1, 2):
        for a, b in zip(runs[0][k], runs[1][k]):
            assert float((a - b).norm()) <= rtol * float(b.norm())


# the reduced hybrid's bf16 gradient and m on the card may be this many
# times as far from the f32 ones as the CPU's (plus f32 noise): on an
# H100 its leaves came 5e-2 - 0.95 from f32 on the card and 5e-2 - 0.68
# on the CPU, at most 2.12 times the CPU's error (a four-element
# ``dt_bias``), 1.0 on the large leaves
HYBRID_BF16_VS_F32_RATIO = 3.0


def test_hybrid_bf16_grads_on_card_held_to_f32(dev):
    """The reduced hybrid in bf16: bf16 rounding alone moves its
    gradients 5-8% (the large leaves) to 68% (``blocks/3/d_skip``, a
    four-element sum that cancels to 5e-3) from the f32 gradient of the
    same params on the CPU itself, so card against CPU is no test at
    rtol 3e-2.  Each leaf's gradient and ``m`` on the card is held to the
    f32 ones instead: within HYBRID_BF16_VS_F32_RATIO times the CPU's
    bf16 error, plus 1e-4; loss and grad norm card against CPU within
    3e-2."""
    from repro_torch.tree import tree_map
    p16 = _family_train("zamba2_1p2b", "cpu", dtype="bfloat16")[1]
    f32 = _family_grads_and_m("zamba2_1p2b", "cpu", "float32",
                              tree_map(lambda t: t.float(), p16))
    card, cpu = (_family_grads_and_m("zamba2_1p2b", d, "bfloat16", p16)
                 for d in (dev, "cpu"))
    np.testing.assert_allclose(card[0], cpu[0], rtol=3e-2)
    for k in (1, 2):
        for a, b, r in zip(card[k], cpu[k], f32[k]):
            e_card = float((a - r).norm() / r.norm())
            e_cpu = float((b - r).norm() / r.norm())
            assert e_card <= HYBRID_BF16_VS_F32_RATIO * e_cpu + 1e-4


# ---------------------------------------------------------------------------
# sharded serving: the kernels at a rank's shapes
# ---------------------------------------------------------------------------
SHARDED_KN = {"wq": (4096, 2048), "wo": (2048, 4096), "w1/w3": (4096, 6848),
              "w2": (6848, 4096)}


@pytest.mark.parametrize("name", sorted(SHARDED_KN))
def test_matmul_bf16_at_sharded_shapes(dev, name):
    """One rank's projections of full-width chatglm3-6b on a (1, 2) mesh
    (columns of wq / w1 / w3, rows of wo / w2) at a decode batch of 8,
    e4m3 weights quantized on the card, against the plain version."""
    k, n = SHARDED_KN[name]
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.normal(size=(8, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.016)
    mw = MXWeight.quantize(w.to(dev), QuantSpec.parse("e4m3@32:ocp"))
    a = a.to(dev).to(torch.bfloat16)
    got = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
    want = mx_matmul_2d(a.cpu(), mw.codes.cpu(), mw.scales.cpu(), mw.spec)
    torch.cuda.synchronize()
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=tol)


# (q heads of the rank, KV heads of the cache, rep, first q head): a rank
# of chatglm3-6b at model 4 (8 of 32 heads over both KV heads), the
# reduced config's at model 4, and slices that straddle a KV group
HEAD0_CASES = [(8, 2, 16, 8), (8, 2, 16, 24), (1, 2, 2, 3), (6, 4, 4, 5),
               (16, 2, 16, 0), (3, 2, 4, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", HEAD0_CASES)
def test_decode_attention_head0_matches_plain(dev, case, dtype):
    """B4 over a contiguous cache holding every KV head, q a slice of the
    heads from ``head0``: against the plain version (f32 within 2e-5,
    bf16 within torch's bf16 defaults), at positions across splits."""
    hq, hkv, rep, head0 = case
    d = 128 if dtype == "bfloat16" else 64
    ks_, vs_ = QuantSpec.parse("int8@32:ocp"), QuantSpec.parse("e2m1@32:ocp")
    rng = np.random.default_rng(hq + head0)
    args = _contiguous_case(rng, ks_, vs_, b=3, s=200, hq=hq, hkv=hkv, d=d)
    args[0] = args[0].to(getattr(torch, dtype))
    kw = dict(key_spec=ks_, value_spec=vs_, rep=rep, head0=head0)
    on_dev = [t.to(dev) for t in args]
    for pos in (0, 17, 64, 199):
        want = mx_decode_attention(*args, pos, **kw)
        got = mx_decode_attention(*on_dev, pos, **kw)
        torch.cuda.synchronize()
        tol = {} if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", HEAD0_CASES)
def test_paged_attention_head0_matches_plain(dev, case, dtype):
    """B3 over a page pool holding every KV head, q a slice of the heads
    from ``head0``, INT8 keys and packed E2M1 values, against the plain
    version; at head0 0 over every head the kernels give the bits of
    the default (no head0) call."""
    hq, hkv, rep, head0 = case
    d = 128 if dtype == "bfloat16" else 64
    ks_, vs_ = QuantSpec.parse("int8@32:ocp"), QuantSpec.parse("e2m1@32:ocp")
    rng = np.random.default_rng(7 * hq + head0)
    args = list(_paged_case(rng, ks_, vs_, hq=hq, hkv=hkv, d=d))
    args[0] = args[0].to(getattr(torch, dtype))
    kw = dict(key_spec=ks_, value_spec=vs_, rep=rep, head0=head0)
    want = mx_paged_decode_attention(*args, **kw)
    on_dev = [t.to(dev) for t in args]
    got = mx_paged_decode_attention(*on_dev, **kw)
    torch.cuda.synchronize()
    tol = {} if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.cpu(), want, **tol)
    if head0 == 0 and hq == hkv * rep:
        kw.pop("head0")
        assert torch.equal(got, mx_paged_decode_attention(*on_dev, **kw))


@pytest.mark.parametrize("fmt", ["e4m3", "e2m1", "int8"])
def test_fake_quant_of_gathered_shard_matches_plain(dev, fmt):
    """Sharded training at mesh (2, 2) of chatglm3-6b: B1's fake-quant of
    a rank's gathered shards (w1 4096 x 6848: K whole after the FSDP
    gather; w2's K rows over "model", 6848 x 4096) equals the plain round
    trip bit for bit, and the K shard's codes and scales equal the whole
    weight's, sliced: its blocks line up ((K / 2) % 32 == 0)."""
    from repro_torch.core import convert
    from repro_torch.kernels.ops import fake_quantize, mx_quantize
    rng = np.random.default_rng(9)
    spec = QuantSpec(fmt, "ocp")
    for k, n in ((4096, 6848), (6848, 4096)):
        w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                             * 0.016)
        before = mx_quantize_2d.launches
        got = fake_quantize(w.to(dev), spec, axis=0)
        assert mx_quantize_2d.launches == before + 1
        want = convert.quantize_dequantize(w, spec, axis=0)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    w2 = torch.from_numpy(rng.normal(size=(13696, 4096)).astype(np.float32)
                          * 0.016).to(dev)
    whole = mx_quantize(w2, spec, axis=0)
    for r in range(2):
        part = mx_quantize(w2[r * 6848:(r + 1) * 6848], spec, axis=0)
        assert torch.equal(part.codes, whole.codes[r * 6848:(r + 1) * 6848])
        assert torch.equal(part.scales, whole.scales[r * 214:(r + 1) * 214])


def test_flash_at_a_rank_heads_of_train_shard(dev):
    """B5 on one rank of sharded training at mesh (2, 2): its batch of
    2 x 512 and its heads (Hq 16 over Hkv 1, D 128), causal, bf16,
    against the plain version within the bf16 tolerance (2e-2), and its
    autograd route (``flash_attention_vjp``) giving the plain backward's
    gradients."""
    from repro_torch.kernels.flash_attn import flash_attention_vjp
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(2, 512, h, 128, generator=g, device=dev)
               .to(torch.bfloat16) for h in (16, 1, 1))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    qs, ks, vs = (t.float().requires_grad_(True) for t in (q, k, v))
    out = flash_attention_vjp(qs, ks, vs, causal=True)
    out.square().sum().backward()
    qp, kp, vp = (t.float().requires_grad_(True) for t in (q, k, v))
    ref.flash_attention_ref(qp, kp, vp, True).square().sum().backward()
    for a, b in ((qs, qp), (ks, kp), (vs, vp)):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-3, atol=1e-3)
