"""Mamba2 (SSD) block, the zamba2 backbone (mirrors
src/repro/models/ssm.py).

The SSD recurrence per head h (scalar decay a_t, state S in R^{P x N}):
    S_t = a_t * S_{t-1} + dt_t * x_t (x) B_t       a_t = exp(-exp(A) dt_t)
    y_t = C_t . S_t
is evaluated in chunks of ``CHUNK`` positions over a whole prompt:
within a chunk by a masked (C x C) decay-weighted product, across chunks
by a sequential loop over chunk states (the reference's ``lax.scan``;
there is no Pallas kernel on this path, so it is plain PyTorch with the
reference's chunk size and order of f32 operations).  Decode keeps the
exact one-step recurrence.  The decode step updates its ``ssm`` and
``conv`` states in place (the reference returns them): a captured decode
graph reads and writes the same buffers every replay.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, rms_norm

HEAD_DIM = 64
CHUNK = 64


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, ssm state N, heads) of a Mamba2 block."""
    din = cfg.ssm_expand * cfg.d_model
    return din, cfg.ssm_state, din // HEAD_DIM


def mamba_init(normal, cfg: ModelConfig, device) -> Dict[str, Any]:
    """One block's weights as the reference's ``mamba_init`` lays them
    out; ``normal(shape, std, dtype)`` draws from the caller's seeded
    generator."""
    d = cfg.d_model
    din, n, nh = dims(cfg)
    conv_ch = din + 2 * n
    dt, f32 = cfg.torch_dtype, torch.float32
    return {
        # fused in_proj: [z din | x din | B n | C n | dt nh]
        "in_proj": normal((d, 2 * din + 2 * n + nh), d ** -0.5, dt),
        "conv_w": normal((cfg.d_conv, conv_ch), 0.2, dt),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "a_log": torch.zeros(nh, dtype=f32, device=device),
        "dt_bias": torch.full((nh,), -2.0, dtype=f32, device=device),
        "d_skip": torch.ones(nh, dtype=f32, device=device),
        "norm": torch.ones(din, dtype=dt, device=device),
        "out_proj": normal((din, d), din ** -0.5, dt),
    }


def _causal_conv_full(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, S, C), w (K, C), taps summed in the
    reference's order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _ssd_chunked(xh, bmat, cmat, la, chunk: int):
    """Chunked SSD scan.

    xh   (B, S, H, P)  dt-scaled inputs
    bmat (B, S, N), cmat (B, S, N)  shared across heads (n_groups=1)
    la   (B, S, H)     log decay per step (<= 0)
    returns y (B, S, H, P) in xh's dtype, final state (B, H, P, N) f32
    """
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = s // chunk
    f32, dt = torch.float32, xh.dtype
    xc = xh.reshape(bsz, nc, chunk, h, p)
    bc = bmat.reshape(bsz, nc, chunk, n)
    cc = cmat.reshape(bsz, nc, chunk, n)
    lcum = torch.cumsum(la.reshape(bsz, nc, chunk, h), dim=2)   # inclusive
    # intra-chunk: y[t] += sum_{s<=t} exp(L_t - L_s) (C_t.B_s) xh_s
    g = torch.einsum("bctn,bcsn->bcts", cc.to(f32), bc.to(f32))
    dmat = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]     # (b,c,t,s,h)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    dmat = torch.where(mask[None, None, :, :, None], dmat, -torch.inf)
    w = torch.exp(dmat) * g[..., None]                          # (b,c,t,s,h)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", w.to(dt).to(f32),
                           xc.to(f32))
    # inter-chunk state scan
    ldec_in = lcum[:, :, -1:, :] - lcum                         # s -> end
    binp = torch.einsum(
        "bcsn,bcshp->bchpn", bc.to(f32),
        (xc * torch.exp(ldec_in).to(dt)[..., None]).to(f32))   # (b,c,h,p,n)
    lend = lcum[:, :, -1, :]                                    # (b,c,h)
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(state)                                      # BEFORE
        state = state * torch.exp(lend[:, c])[:, :, None, None] + binp[:, c]
    prev = torch.stack(prev, dim=1)                             # (b,c,h,p,n)
    y_inter = torch.einsum("bctn,bchpn->bcthp", cc.to(f32),
                           prev.to(dt).to(f32)) * torch.exp(lcum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(dt), state


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, n, _ = dims(cfg)
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din],
            zxbcdt[..., 2 * din:2 * din + n],
            zxbcdt[..., 2 * din + n:2 * din + 2 * n],
            zxbcdt[..., 2 * din + 2 * n:])


def _gate_out(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
              fake_quant: bool) -> torch.Tensor:
    dt = z.dtype
    y = y * F.silu(z.to(torch.float32)).to(dt)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return dense(y, p["out_proj"], cfg.mx, fake_quant)


def mamba_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict] = None, fake_quant: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence (train / prefill) Mamba2 block over x (B, S, d); a
    prompt is padded to a whole chunk (zero inputs, zero log decay: the
    padding changes neither the outputs nor the final state).  A given
    ``cache`` ({"ssm", "conv"}, one block's) receives the final states in
    place."""
    b, s, _ = x.shape
    din, n, nh = dims(cfg)
    dt, f32 = x.dtype, torch.float32
    zxbcdt = dense(x, p["in_proj"], cfg.mx, fake_quant)
    z, xs, bmat, cmat, dtr = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv = _causal_conv_full(conv_in, p["conv_w"].to(dt), p["conv_b"].to(dt))
    conv = F.silu(conv.to(f32)).to(dt)
    xs, bmat, cmat = conv[..., :din], conv[..., din:din + n], \
        conv[..., din + n:]
    dtv = F.softplus(dtr.to(f32) + p["dt_bias"][None, None, :])  # (B,S,H)
    la = -torch.exp(p["a_log"])[None, None, :] * dtv             # log decay
    xh = xs.reshape(b, s, nh, HEAD_DIM)
    xdt = xh * dtv[..., None].to(dt)
    chunk = min(CHUNK, s)
    pad = (-s) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
    y, final = _ssd_chunked(xdt, bmat, cmat, la, chunk)
    y = y[:, :s]
    y = y + xh * p["d_skip"][None, None, :, None].to(dt)
    out = _gate_out(p, y.reshape(b, s, din), z, cfg, fake_quant)
    if cache is not None:
        k1 = cfg.d_conv - 1
        tail = F.pad(conv_in, (0, 0, max(0, k1 - s), 0))[:, -k1:, :]
        cache["ssm"].copy_(final)
        cache["conv"].copy_(tail.to(cache["conv"].dtype))
    return out, cache


def mamba_init_cache(cfg: ModelConfig, batch: int, device,
                     layers_dim: Tuple[int, ...] = ()):
    """Decode state of one block (optionally stacked): ``ssm`` (B, H, P,
    N) f32 and ``conv`` (B, d_conv - 1, d_inner + 2N), the last inputs of
    the causal conv."""
    din, n, nh = dims(cfg)
    return {"ssm": torch.zeros(layers_dim + (batch, nh, HEAD_DIM, n),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(layers_dim + (batch, cfg.d_conv - 1,
                                              din + 2 * n),
                                dtype=cfg.torch_dtype, device=device)}


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: Dict,
                 fake_quant: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One-token decode with the exact recurrence, x (B, 1, d); the
    block's ``ssm`` and ``conv`` states are updated in place."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mamba_decode takes one token, got {s}")
    din, n, nh = dims(cfg)
    dt, f32 = x.dtype, torch.float32
    zxbcdt = dense(x, p["in_proj"], cfg.mx, fake_quant)
    z, xs, bmat, cmat, dtr = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)               # (B,1,C)
    hist = torch.cat([cache["conv"], conv_in], dim=1)           # (B,K,C)
    conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"].to(dt))[:, None, :] \
        + p["conv_b"][None, None, :].to(dt)
    conv = F.silu(conv.to(f32)).to(dt)
    xs, bmat, cmat = conv[..., :din], conv[..., din:din + n], \
        conv[..., din + n:]
    dtv = F.softplus(dtr.to(f32) + p["dt_bias"][None, None, :])[:, 0]
    a = torch.exp(-torch.exp(p["a_log"])[None, :] * dtv)        # (B,H)
    xh = xs.reshape(b, nh, HEAD_DIM)
    xdt = (xh * dtv[..., None]).to(f32)
    s_new = cache["ssm"] * a[:, :, None, None] \
        + torch.einsum("bhp,bn->bhpn", xdt, bmat[:, 0].to(f32))
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].to(f32), s_new)
    y = y + xh.to(f32) * p["d_skip"][None, :, None]
    out = _gate_out(p, y.reshape(b, 1, din).to(dt), z, cfg, fake_quant)
    cache["ssm"].copy_(s_new)
    cache["conv"].copy_(hist[:, 1:, :])
    return out, cache
