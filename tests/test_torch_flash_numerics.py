"""The precision premise of the tensor-core flash kernel (csrc/flash_attn_tc.cu).

That kernel forms S = Q K^T exactly (bf16 products summed in f32), keeps
the online softmax in f32 over 64-key tiles, and rounds P to bf16 as the
A operand of O += P V, with l summed from the f32 P.  It runs only on the
card; here a plain-torch emulation of that arithmetic is held against the
reference's Pallas flash kernel in interpret mode at bf16, at the
reference's bf16 tolerance, 2e-2 (tests/test_kernel_flash_attn.py), with
a peaked softmax (scores x8) among the cases.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as j_flash

torch.set_num_threads(1)

NEG_INF = -1e30
TILE = 64          # keys per tile, as in the kernel
TOL = 2e-2


def _emulate(q, k, v, causal):
    """The kernel's arithmetic on bf16 q (B, Sq, H, D), k/v (B, Sk, Hkv, D):
    per 64-key tile, logits s * (1/sqrt(D)) in f32 taken to base 2, masked
    to NEG_INF, online max and sum in f32, P rounded to bf16 before P V;
    the output divided by l and rounded to bf16."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qf = q.float().transpose(1, 2)                       # (B, H, Sq, D)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, TILE):
        cols = torch.arange(k0, min(k0 + TILE, sk))
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, cols]) * scale
        x = x * log2e
        if causal:
            x = torch.where(cols[None, :] <= rows, x, NEG_INF)
        mx = torch.maximum(m, x.amax(-1))
        p = torch.exp2(x - mx[..., None])
        alpha = torch.exp2(m - mx)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                          vf[:, :, cols])
        acc = acc * alpha[..., None] + pv
        m = mx
    den = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / den[..., None]).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("case", [
    (1, 128, 128, 16, 1, 128, True, 1.0),     # rep 16, D 128
    (1, 128, 128, 16, 1, 128, True, 8.0),     # scores x8: peaked softmax
    (2, 96, 96, 4, 2, 64, True, 1.0),         # ragged, ends mid-tile
    (1, 64, 192, 2, 2, 32, True, 1.0),        # Sq < Sk: top-left causal
    (1, 160, 100, 4, 1, 64, True, 1.0),       # Sq > Sk
    (1, 64, 130, 4, 2, 32, False, 8.0),       # non-causal, ragged Sk
])
def test_emulated_kernel_arithmetic_matches_pallas_interpret(case):
    b, sq, sk, h, hkv, d, causal, qscale = case
    rng = np.random.default_rng(sq * 1000 + sk + d)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32) * qscale
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = _emulate(*bf, causal).float().numpy()
    # the same bf16 inputs through the reference's Pallas kernel
    want = j_flash(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                     for t in bf), causal, True)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    worst = float(np.abs(got - want).max())
    assert np.allclose(got, want, rtol=TOL, atol=TOL), \
        f"emulated kernel vs Pallas flash: max |error| {worst} (tol {TOL})"
