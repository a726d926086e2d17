"""The fused MX KV write's plain versions (what the wrappers compute on
CPU tensors) against the JAX package's cache writes: bit for bit.

``mx_paged_kv_write`` finds each slot's page and offset from
``block_tables`` and ``lengths`` itself; the reference's
``paged_cache_write`` is handed them, computed as its
``attention_paged_decode`` does.  Likewise ``mx_paged_kv_write_tokens``
(a span of tokens per row from ``starts``, live below ``ends``, bucket
padding on the trash page) against ``paged_cache_write_tokens``, handed
the pages and offsets its ``attention_paged_prefill`` computes.
``mx_cache_kv_write`` against ``cache_write``.  Identical k/v in must give identical pool and cache
bytes out: codes, packed codes, padding codes and E8M0 scales, the
trash page's collided writes included.  The one known difference (C4 in
ROADMAP.md): a NaN or Inf in a padded last block in paper mode gives the
reference marker codes in the padding and the port zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.kernels.mx_kv_write import (mx_cache_kv_write,
                                             mx_paged_kv_write,
                                             mx_paged_kv_write_tokens)
from repro_torch.models import layers as TL
from repro_torch.models import load_reduced as t_load_reduced

torch.set_num_threads(1)

PAGE, NUM_PAGES, N_KV = 8, 13, 2
# the policies of test_torch_model.py::test_paged_cache_write_bit_identical
# plus 6-bit packed OCP codes and paper-mode INT8 keys
POLICIES = ["kv_key=int8@32:ocp,kv_value=e2m1@32:ocp", "kv=e3m2@32:paper",
            "kv=e4m3@32:ocp+unpacked", "kv_key=int8@32:paper,"
            "kv_value=e2m3@32:ocp", "kv=e5m2@32:paper+unpacked"]


def _cfgs(policy, hd):
    return (j_load_reduced("chatglm3_6b", mx=JPolicy.parse(policy),
                           head_dim=hd),
            t_load_reduced("chatglm3_6b", mx=TPolicy.parse(policy),
                           head_dim=hd))


def _kv(rng, shape, dtype, special=False):
    """k and v as (jax, torch) pairs of the same bits; ``special`` puts a
    NaN in one block and an Inf in another (paper-mode markers).  bf16 is
    rounded once, by torch, and handed to JAX bit for bit (the two give a
    NaN different signs)."""
    out = []
    for _ in range(2):
        x = rng.normal(size=shape).astype(np.float32)
        x[..., 1, :] *= np.float32(1e-39)         # f32 subnormals
        if special:
            x[0, 0, 0, 3] = np.nan
            x[-1, -1, -1, 0] = -np.inf
        j, t = jnp.asarray(x), torch.from_numpy(x)
        if dtype == "bfloat16":
            t = t.to(torch.bfloat16)
            j = jax.lax.bitcast_convert_type(
                jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
        out.append((j, t))
    return out


def _pool(jcfg):
    pool = JL.init_paged_kv_cache(jcfg, NUM_PAGES, PAGE, N_KV, jcfg.hd)
    rng = np.random.default_rng(5)          # non-zero bytes to overwrite
    return {n: rng.integers(0, 256, size=a.shape).astype(np.uint8)
            for n, a in pool.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 48])
@pytest.mark.parametrize("policy", POLICIES)
def test_paged_kv_write_bit_identical(policy, hd, dtype):
    """Four slots: mid-page, the last offset of a page, offset 0 of a
    fresh page, and an idle slot on the trash page."""
    jcfg, tcfg = _cfgs(policy, hd)
    pool = _pool(jcfg)
    bt = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 0], [0, 0, 0]], np.int32)
    lengths = np.array([20, PAGE - 1, PAGE, 0], np.int32)
    rng = np.random.default_rng(hd)
    (jk, tk), (jv, tv) = _kv(rng, (4, 1, N_KV, hd), dtype,
                             special="paper" in policy)
    pages = np.take_along_axis(bt, (lengths // PAGE)[:, None], 1)[:, 0]
    jout = jax.jit(lambda *a: JL.paged_cache_write(*a, jcfg))(
        {n: jnp.asarray(a) for n, a in pool.items()}, jk, jv,
        jnp.asarray(pages), jnp.asarray(lengths % PAGE))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    mx_paged_kv_write(tpool, tk, tv, torch.from_numpy(bt),
                      torch.from_numpy(lengths), tcfg.mx.kv_key,
                      tcfg.mx.kv_value)
    for name, a in jout.items():
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(a),
                                      err_msg=name)


# rows of a multi-token write (pages of 8, tables of 4 pages, S 6): a span
# from a page's middle across a boundary, a span ending in bucket padding
# (positions 14.. go to the trash page at offsets 6, 7, 0, 1), a span
# that starts and ends mid-page, and a row of padding only
TOKEN_ROWS = {"block_tables": [[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9],
                               [10, 0, 0, 0]],
              "starts": [5, 12, 17, 3], "ends": [11, 14, 23, 3]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 48])
@pytest.mark.parametrize("policy", [POLICIES[0], POLICIES[1]])
def test_paged_kv_write_tokens_bit_identical(policy, hd, dtype):
    """INT8 keys with packed E2M1 values, and packed E3M2 (paper mode)
    both ways: every page but the trash page bit for bit, and the trash
    page at the offsets exactly one padded token writes (where tokens
    collide there, either may win, in the reference as in the port)."""
    jcfg, tcfg = _cfgs(policy, hd)
    pool = _pool(jcfg)
    bt = np.array(TOKEN_ROWS["block_tables"], np.int32)
    starts = np.array(TOKEN_ROWS["starts"], np.int32)
    ends = np.array(TOKEN_ROWS["ends"], np.int32)
    s = 6
    rng = np.random.default_rng(hd + 1)
    (jk, tk), (jv, tv) = _kv(rng, (4, s, N_KV, hd), dtype,
                             special="paper" in policy)
    # the reference's attention_paged_prefill page math
    pos = starts[:, None] + np.arange(s)[None, :]
    live = pos < ends[:, None]
    pages = np.where(live, np.take_along_axis(
        bt, np.clip(pos // PAGE, 0, bt.shape[1] - 1), 1), 0)
    assert (pages[~live] == 0).all() and (~live).any()
    jout = jax.jit(lambda *a: JL.paged_cache_write_tokens(*a, jcfg))(
        {n: jnp.asarray(a) for n, a in pool.items()}, jk, jv,
        jnp.asarray(pages), jnp.asarray(pos % PAGE))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    mx_paged_kv_write_tokens(tpool, tk, tv, torch.from_numpy(bt),
                             torch.from_numpy(starts), torch.from_numpy(ends),
                             tcfg.mx.kv_key, tcfg.mx.kv_value)
    offs, counts = np.unique((pos % PAGE)[~live], return_counts=True)
    once = offs[counts == 1]
    assert once.size and (counts > 1).any()
    for name, a in jout.items():
        want, got = np.asarray(a), tpool[name].numpy()
        np.testing.assert_array_equal(got[1:], want[1:], err_msg=name)
        np.testing.assert_array_equal(got[0, once], want[0, once],
                                      err_msg=name)
    # nothing but the live positions and the trash page changed
    touched = np.zeros(pool["kc_pages"].shape[:2], bool)
    touched[pages, pos % PAGE] = True
    for name, a in pool.items():
        np.testing.assert_array_equal(tpool[name].numpy()[~touched],
                                      a[~touched], err_msg=name)


def test_paged_kv_write_tokens_rejects_rows_it_cannot_place():
    """A live position past its table, or a table entry below 0, raises
    (the kernel traps on both: tests/test_torch_cuda.py::
    test_paged_kv_write_tokens_matches_plain_and_traps); positions past
    ``ends`` never read the table."""
    jcfg, tcfg = _cfgs(POLICIES[0], 32)
    pool = {n: torch.from_numpy(a) for n, a in _pool(jcfg).items()}
    k = torch.ones(2, 4, N_KV, 32)
    kk, vv = tcfg.mx.kv_key, tcfg.mx.kv_value
    bt = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)

    def write(starts, ends):
        return mx_paged_kv_write_tokens(
            pool, k, k, bt, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(ends, dtype=torch.int32), kk, vv)

    write([12, 0], [16, 4])                        # padding: never looked up
    write([0, 4], [4, 6])                          # page -1 lies past ends
    with pytest.raises(IndexError):
        write([14, 0], [18, 4])                    # position 16: no entry
    with pytest.raises(IndexError):
        write([0, 6], [4, 10])                     # page -1 is live


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 48])
@pytest.mark.parametrize("policy", POLICIES[:3])
def test_cache_kv_write_bit_identical(policy, hd, dtype):
    """A prefill of 5 positions, then two decode writes."""
    jcfg, tcfg = _cfgs(policy, hd)
    jcache = JL.init_kv_cache(jcfg, 2, 16, N_KV, hd)
    tcache = TL.init_kv_cache(tcfg, 2, 16, N_KV, hd, "cpu")
    rng = np.random.default_rng(9)
    jwrite = jax.jit(lambda *a: JL.cache_write(*a, jcfg))
    for pos, s in ((0, 5), (5, 1), (15, 1)):
        (jk, tk), (jv, tv) = _kv(rng, (2, s, N_KV, hd), dtype,
                                 special="paper" in policy)
        jcache = jwrite(jcache, jk, jv, jnp.asarray(pos, jnp.int32))
        mx_cache_kv_write(tcache, tk, tv, pos, tcfg.mx.kv_key,
                          tcfg.mx.kv_value)
    for name, a in jcache.items():
        np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(a),
                                      err_msg=name)


def test_kv_write_rejects_bad_operands():
    """Shapes the write cannot place raise before anything is written."""
    jcfg, tcfg = _cfgs(POLICIES[0], 32)
    kk, kv = tcfg.mx.kv_key, tcfg.mx.kv_value
    cache = TL.init_kv_cache(tcfg, 2, 16, N_KV, 32, "cpu")
    k = torch.zeros(2, 3, N_KV, 32)
    with pytest.raises(ValueError, match="do not fit"):
        mx_cache_kv_write(cache, k, k, 14, kk, kv)
    with pytest.raises(ValueError, match="one dtype"):
        mx_cache_kv_write(cache, k, k.to(torch.bfloat16), 0, kk, kv)
    pool = TL.init_paged_kv_cache(tcfg, NUM_PAGES, PAGE, N_KV, 32, "cpu")
    bt = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(B, 1, n_kv, hd\)"):
        mx_paged_kv_write(pool, k, k, bt, ln, kk, kv)
    with pytest.raises(ValueError, match="cache leaf"):
        mx_paged_kv_write(pool, k[:, :1], k[:, :1], bt, ln, kv, kk)


def test_cache_kv_write_padded_block_nan_is_c4():
    """Head dim 48 in paper mode with a NaN in the padded last block
    (codes 32..63): scales and codes 0..47 match the reference bit for
    bit; the padding codes 48..63 of that row are the reference's NaN
    markers and the port's zeros (C4).  Nothing reads them."""
    policy, hd = "kv=e3m2@32:paper", 48
    jcfg, tcfg = _cfgs(policy, hd)
    jcache = JL.init_kv_cache(jcfg, 2, 4, N_KV, hd)
    tcache = TL.init_kv_cache(tcfg, 2, 4, N_KV, hd, "cpu")
    rng = np.random.default_rng(16)
    (jk, tk), (jv, tv) = _kv(rng, (2, 1, N_KV, hd), "float32")
    k = np.asarray(jk).copy()
    k[1, 0, 1, 40] = np.nan
    jk, tk = jnp.asarray(k), torch.from_numpy(k)
    jcache = JL.cache_write(jcache, jk, jv, jnp.asarray(2, jnp.int32), jcfg)
    mx_cache_kv_write(tcache, tk, tv, 2, tcfg.mx.kv_key, tcfg.mx.kv_value)
    for name, a in jcache.items():
        want, got = np.asarray(a).copy(), tcache[name].numpy().copy()
        if name == "k_codes":
            assert not got[1, 2, 1, hd:].any()
            assert (want[1, 2, 1, hd:] != 0).all()
            want[1, 2, 1, hd:] = got[1, 2, 1, hd:]
        np.testing.assert_array_equal(got, want, err_msg=name)


# a slot whose length lies past its 3-page table, or whose table names
# page 99 or page -1 of the pool
BAD_SLOTS = {"length past the table": ([[1, 2, 3], [4, 5, 6]], [24, 9]),
             "page past the pool": ([[1, 2, 3], [4, 99, 6]], [5, 9]),
             "page below 0": ([[1, 2, 3], [4, -1, 6]], [5, 9])}


@pytest.mark.parametrize("case", sorted(BAD_SLOTS))
def test_paged_kv_write_rejects_slots_it_cannot_place(case):
    """The plain version raises where the kernel traps (its card twin is
    tests/test_torch_cuda.py::
    test_paged_kv_write_rejects_rows_past_their_table)."""
    jcfg, tcfg = _cfgs(POLICIES[0], 32)
    pool = {n: torch.from_numpy(a) for n, a in _pool(jcfg).items()}
    bt, lengths = BAD_SLOTS[case]
    k = torch.ones(2, 1, N_KV, 32)
    with pytest.raises((IndexError, RuntimeError)):
        mx_paged_kv_write(pool, k, k, torch.tensor(bt, dtype=torch.int32),
                          torch.tensor(lengths, dtype=torch.int32),
                          tcfg.mx.kv_key, tcfg.mx.kv_value)


@pytest.mark.parametrize("policy", POLICIES[:3])
def test_cache_kv_write_device_pos_bit_identical(policy):
    """The contiguous write at a position held in a one-element int32
    tensor writes the host int's bytes; a tensor position outside the
    cache raises as the host int does."""
    _, tcfg = _cfgs(policy, 32)
    kk, vv = tcfg.mx.kv_key, tcfg.mx.kv_value
    rng = np.random.default_rng(5)
    for pos, s in ((0, 5), (7, 1), (11, 1)):
        want = TL.init_kv_cache(tcfg, 2, 12, N_KV, 32, "cpu")
        got = {k: v.clone() for k, v in want.items()}
        (_, k), (_, v) = _kv(rng, (2, s, N_KV, 32), "float32")
        mx_cache_kv_write(want, k, v, pos, kk, vv)
        mx_cache_kv_write(got, k, v, torch.tensor([pos], dtype=torch.int32),
                          kk, vv)
        for n in want:
            assert torch.equal(got[n], want[n]), (pos, n)
    for bad in (-1, 12):
        with pytest.raises(ValueError, match="do not fit"):
            mx_cache_kv_write(got, k, v, torch.tensor([bad],
                                                      dtype=torch.int32),
                              kk, vv)
    with pytest.raises(ValueError, match="one int32"):
        mx_cache_kv_write(got, k, v, torch.tensor([3]), kk, vv)
