"""The precision premise of the tensor-core MX decode-attention kernels
(csrc/mx_decode_attn_tc.cu).

Those kernels decode K and V to bf16 with the E8M0 scale folded in (exact
for scale codes >= 10), form S = Q K^T with bf16 products summed in f32,
run the online softmax in f32 over 16-position tiles (warp w of a
4-warp block takes tiles w, w + 4, ... of its split), feed P to P V as
two bf16 parts (hi = bf16(p), lo = bf16(p - hi)) with l summed from the
f32 P, merge the warps of a block and then the blocks' splits in order,
and round the output to bf16.  They run only on the card; here a
plain-torch emulation of that arithmetic is held against the reference's
Pallas kernels in interpret mode at bf16, with the criterion the card
uses (torch's bf16 defaults, ``chip_smoke.py``), at the wrapper's split
and at one split per row (every warp walking several tiles).  Three
mutants of the emulation must fail the same criterion: no online rescale,
P rounded to steps of 1/64, and P rounded once to bf16 (no lo part: why
the kernels feed P as two parts).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pack import pack_codes as jpack_codes
from repro.core.spec import QuantSpec as JSpec
from repro.kernels import ref as jref
from repro.kernels.mx_decode_attn import mx_decode_attention as j_decode
from repro.kernels.mx_decode_attn import \
    mx_paged_decode_attention as j_paged
from repro_torch.core.pack import unpack_codes
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.kernels import tables
from repro_torch.kernels.mx_decode_attn import TC_ROWS, split_tokens

torch.set_num_threads(1)

NEG_INF = -1e30
TILE, WARPS = 16, 4
CPU = torch.device("cpu")


def _fold(codes, scales, spec):
    """(..., D) codes, one per byte, + (..., D/32) scales -> the kernel's
    operand: elem * 2^(s-127) rounded once to bf16, as f32."""
    spec = TSpec.parse(spec)
    elem = tables.elem_table(spec, CPU)[codes.long()]
    sc = tables.scale_table(CPU)[scales.long()]
    w = elem.reshape(*codes.shape[:-1], -1, 32) * sc[..., None]
    return w.reshape(codes.shape).to(torch.bfloat16).float()


def _merge(states):
    """(m, l, acc) states merged in order, as the kernels merge warps and
    splits: weights exp(m_i - max m), sums in list order."""
    mm = states[0][0]
    for m, _, _ in states[1:]:
        mm = torch.maximum(mm, m)
    ll, acc = torch.zeros_like(mm), None
    for m, l, a in states:
        w = torch.exp(m - mm)
        ll = ll + l * w
        acc = a * w[..., None] if acc is None else acc + a * w[..., None]
    return mm, ll, acc


def _emulate(q, k, v, live, rep, st, *, rescale=True, p_step=None,
             p_lo=True):
    """The kernels' arithmetic.  q (B, Hq, D) bf16; k, v (B, S, Hkv, D)
    folded operands; live (B,) positions each row attends; st positions
    per split.  Returns (B, Hq, D) bf16."""
    b, hq, d = q.shape
    s_len = k.shape[1]
    qf = q.float()
    ke = k.repeat_interleave(rep, dim=2).transpose(1, 2)   # (B, Hq, S, D)
    ve = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    sqrt_d = torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    live = torch.as_tensor(live, dtype=torch.int64)
    splits = []
    for t0 in range(0, int(live.max()), st):
        t1 = torch.clamp(live, max=t0 + st)                # (B,)
        warps = []
        for w in range(WARPS):
            m = torch.full((b, hq), NEG_INF)
            l = torch.zeros(b, hq)
            acc = torch.zeros(b, hq, d)
            for tok0 in range(t0 + TILE * w, t0 + st, TILE * WARPS):
                act = tok0 < t1                            # (B,)
                if not bool(act.any()):
                    break
                tok = torch.arange(tok0, tok0 + TILE)
                idx = torch.clamp(tok, max=s_len - 1)
                valid = tok[None, :] < t1[:, None]         # (B, 16)
                x = torch.einsum("bhd,bhkd->bhk", qf, ke[:, :, idx]) / sqrt_d
                x = torch.where(valid[:, None, :], x, NEG_INF)
                mx = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - mx)
                p = torch.exp(x - mx[..., None])
                l2 = l * alpha + p.sum(-1)
                vt = ve[:, :, idx] * valid[:, None, :, None]
                if p_step is not None:                     # mutant
                    pv = torch.einsum("bhk,bhkd->bhd",
                                      torch.round(p / p_step) * p_step, vt)
                else:
                    hi = p.to(torch.bfloat16).float()
                    lo = (p - hi).to(torch.bfloat16).float() * p_lo
                    pv = torch.einsum("bhk,bhkd->bhd", hi, vt) \
                        + torch.einsum("bhk,bhkd->bhd", lo, vt)
                acc2 = (acc * alpha[..., None] if rescale else acc) + pv
                a2 = act[:, None]
                m = torch.where(a2, mx, m)
                l = torch.where(a2, l2, l)
                acc = torch.where(a2[..., None], acc2, acc)
            warps.append((m, l, acc))
        m, l, acc = _merge(warps)
        on = (t0 < live)[:, None]                          # split has work
        splits.append((torch.where(on, m, NEG_INF), torch.where(on, l, 0.0),
                       torch.where(on[..., None], acc, 0.0)))
    _, l, acc = _merge(splits)
    den = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / den[..., None]).to(torch.bfloat16)


def _spans(span, pairs):
    """The wrapper's split and one split per row (every warp walking
    several tiles)."""
    return split_tokens(span, pairs), 64 * math.ceil(span / 64)


def _quantized(rng, shape, spec, low_scale=False):
    """(codes, scales) of normal data through the reference converter;
    with low_scale, one 32-block gets scale code 5 (below 10: the bf16
    fold rounds)."""
    d = shape[-1]
    x = rng.normal(size=(int(np.prod(shape[:-1])), d)).astype(np.float32)
    codes, scales = jref.mx_quantize_2d_ref(jnp.asarray(x), spec)
    codes = np.array(codes).reshape(shape)
    scales = np.array(scales).reshape(shape[:-1] + (d // 32,))
    if low_scale:
        scales.reshape(-1, d // 32)[1, 0] = 5
    return codes, scales


# contiguous: (B, S, Hkv, rep, D, K/V specs, pos, q scale, a block with
# scale code 5)
CONTIGUOUS = [
    (2, 96, 1, 16, 128, "int8@32:ocp/e2m1@32:ocp", 90, 1.0, False),
    (2, 64, 2, 7, 64, "int8@32:ocp/e2m1@32:ocp", 0, 1.0, False),
    (1, 80, 2, 1, 64, "e3m2@32:paper/e2m3@32:paper", 77, 1.0, False),
    (1, 160, 1, 16, 64, "int8@32:ocp/int8@32:ocp", 150, 8.0, False),
    (2, 96, 1, 7, 128, "e5m2@32:ocp/e5m2@32:ocp", 95, 1.0, True),
]
SCORES_X8 = CONTIGUOUS[3]


def _contiguous(case):
    b, s, hkv, rep, d, kv, pos, qscale, low = case
    kspec, vspec = (JSpec.parse(x) for x in kv.split("/"))
    rng = np.random.default_rng(s + d + rep)
    q = torch.from_numpy(
        rng.normal(size=(b, 1, hkv * rep, d)).astype(np.float32) * qscale
    ).to(torch.bfloat16)
    kc, ks = _quantized(rng, (b, s, hkv, d), kspec, low)
    vc, vs = _quantized(rng, (b, s, hkv, d), vspec, low)
    want = j_decode(jnp.asarray(q.float().numpy(), dtype=jnp.bfloat16),
                    *(jnp.asarray(a) for a in (kc, ks, vc, vs)),
                    jnp.asarray(pos, jnp.int32), key_spec=kspec,
                    value_spec=vspec, rep=rep, interpret=True)
    want = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    kf = _fold(torch.from_numpy(kc), torch.from_numpy(ks), kv.split("/")[0])
    vf = _fold(torch.from_numpy(vc), torch.from_numpy(vs), kv.split("/")[1])
    live = torch.full((b,), min(pos + 1, s))
    return q[:, 0], kf, vf, live, rep, want[:, 0], b * hkv * math.ceil(
        rep / TC_ROWS)


@pytest.mark.parametrize("case", CONTIGUOUS)
def test_emulated_contiguous_kernel_matches_pallas_interpret(case):
    q, kf, vf, live, rep, want, pairs = _contiguous(case)
    for st in _spans(int(live.max()), pairs):
        got = _emulate(q, kf, vf, live, rep, st)
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got, want, msg=lambda m: f"split {st}: "
                                   + m)


# paged: (B, page, pages per row, Hkv, rep, D, K/V specs, lengths, q scale)
PAGED = [
    (4, 16, 5, 1, 16, 64, "int8@32:ocp/e2m1@32:ocp", (79, 13, 29, 0), 1.0),
    (3, 8, 6, 2, 7, 128, "e3m2@32:paper/e2m3@32:paper", (47, 0, 20), 1.0),
    (3, 16, 4, 2, 1, 64, "e2m1@32:ocp/int8@32:ocp", (63, 4, 40), 8.0),
]


@pytest.mark.parametrize("case", PAGED)
def test_emulated_paged_kernel_matches_pallas_interpret(case):
    """Ragged lengths, an idle slot (length 0, trash-padded block-table
    row) and sub-byte codes bit-packed in the pools."""
    b, page, npg, hkv, rep, d, kv, lengths, qscale = case
    kspec, vspec = (JSpec.parse(x) for x in kv.split("/"))
    rng = np.random.default_rng(page + d + rep)
    n_pool = b * npg + 1
    q = torch.from_numpy(
        rng.normal(size=(b, 1, hkv * rep, d)).astype(np.float32) * qscale
    ).to(torch.bfloat16)
    pools = []
    for spec in (kspec, vspec):
        c, s = _quantized(rng, (n_pool, page, hkv, d), spec)
        stored = np.array(jpack_codes(jnp.asarray(c), spec.fmt)) \
            if spec.packed else c
        pools += [stored, s]
    bt = rng.permutation(np.arange(1, n_pool)).reshape(b, npg)
    lengths = np.asarray(lengths, np.int32)
    live_pages = lengths // page + 1
    bt = np.where(np.arange(npg)[None] < live_pages[:, None], bt, 0)
    bt = bt.astype(np.int32)
    want = j_paged(jnp.asarray(q.float().numpy(), dtype=jnp.bfloat16),
                   *(jnp.asarray(a) for a in pools), jnp.asarray(bt),
                   jnp.asarray(lengths), key_spec=kspec, value_spec=vspec,
                   rep=rep, interpret=True)
    want = torch.from_numpy(np.asarray(want, np.float32)).to(
        torch.bfloat16)[:, 0]
    bt64 = torch.from_numpy(bt).long()

    def gathered(codes, scales, spec, text):
        c = torch.from_numpy(codes)[bt64].reshape(b, npg * page, hkv, -1)
        if spec.packed:
            c = unpack_codes(c, spec.fmt, d)
        s = torch.from_numpy(scales)[bt64].reshape(b, npg * page, hkv, -1)
        return _fold(c, s, text)

    kf = gathered(pools[0], pools[1], kspec, kv.split("/")[0])
    vf = gathered(pools[2], pools[3], vspec, kv.split("/")[1])
    live = torch.from_numpy(lengths).long() + 1
    pairs = b * hkv * math.ceil(rep / TC_ROWS)
    for st in _spans(npg * page, pairs):
        got = _emulate(q[:, 0], kf, vf, live, rep, st)
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got, want, msg=lambda m: f"split {st}: "
                                   + m)


@pytest.mark.parametrize("case, mutant", [
    (SCORES_X8, dict(rescale=False)),
    (SCORES_X8, dict(p_step=1 / 64)),
    (CONTIGUOUS[0], dict(p_lo=False)),
])
def test_emulation_mutants_fail_the_criterion(case, mutant):
    """The criterion bites: without the online rescale alpha, or with P
    rounded to steps of 1/64, the scores x8 case fails; with P rounded
    once to bf16, the rep 16, D 128 case fails (one split: every warp
    walks several tiles)."""
    q, kf, vf, live, rep, want, _ = _contiguous(case)
    st = 64 * math.ceil(int(live.max()) / 64)
    got = _emulate(q, kf, vf, live, rep, st, **mutant)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want)
