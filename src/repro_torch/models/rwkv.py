"""RWKV6 ("Finch") block: data-dependent per-channel decay linear
attention (mirrors src/repro/models/rwkv.py).

Time-mix recurrence per head (d_k = d_v = 64):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          w_t in (0,1), data-dependent
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
A prompt runs the chunked form (chunk 16; log w clamped at -5 per step
keeps the factored exponents finite), a decode step the exact
recurrence.  Both are plain PyTorch, as the reference's are plain jnp
(no Pallas kernel), in the reference's order of f32 operations.  A
prompt that is no multiple of the chunk is padded with log w = -1e-5,
as the reference pads it: the state after the prompt then carries an
extra decay of exp(-1e-5 x pad) (ROADMAP C11), which the port mirrors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense

HEAD_DIM = 64
CHUNK = 16
LOGW_MIN = -5.0
LOGW_PAD = -1e-5    # the log decay of a padded position (the reference's)
DECAY_LORA = 64


def rwkv_init(normal, cfg: ModelConfig, device) -> Dict[str, Any]:
    """One block's time-mix and channel-mix weights as the reference's
    ``rwkv_init`` lays them out; ``normal(shape, std, dtype)`` draws from
    the caller's seeded generator."""
    d = cfg.d_model
    nh = d // HEAD_DIM
    dt, f32 = cfg.torch_dtype, torch.float32

    def dense_init(d_in, d_out):
        return normal((d_in, d_out), d_in ** -0.5, dt)

    return {
        "tmix": {
            "mu": torch.full((5, d), 0.5, dtype=dt, device=device),
            "wr": dense_init(d, d), "wk": dense_init(d, d),
            "wv": dense_init(d, d), "wg": dense_init(d, d),
            "w0": torch.full((d,), -1.5, dtype=f32, device=device),
            "w_a": dense_init(d, DECAY_LORA),
            "w_b": dense_init(DECAY_LORA, d),
            "u": normal((nh, HEAD_DIM), 0.3, f32),
            "ln_w": torch.ones(d, dtype=dt, device=device),
            "wo": dense_init(d, d),
        },
        "cmix": {
            "mu": torch.full((2, d), 0.5, dtype=dt, device=device),
            "wk": dense_init(d, cfg.d_ff), "wv": dense_init(cfg.d_ff, d),
            "wr": dense_init(d, d),
        },
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """x_{t-1} along the sequence; ``prev`` (B, 1, d) is the token before
    the segment (decode), zeros otherwise."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """log w_t (<= 0), data-dependent (LoRA), clamped for the chunked
    form's stability."""
    lora = dense(torch.tanh(dense(xw, p["w_a"]).to(torch.float32))
                 .to(xw.dtype), p["w_b"])
    logw = -torch.exp(p["w0"][None, None, :].to(torch.float32)
                      + lora.to(torch.float32))
    return torch.clamp(logw, LOGW_MIN, -1e-5)


def _wkv_chunked(r, k, v, logw, u, chunk: int):
    """Chunked RWKV6 linear attention from a zero state.

    r, k, v (B, S, H, D); logw (B, S, H, D) per-channel log decay; u (H,
    D) bonus.  Returns y (B, S, H, D) f32 and the final state (B, H, D,
    D) f32 [k-dim x v-dim]."""
    b, s, h, dd = r.shape
    nc = s // chunk
    f32 = torch.float32
    rc = r.reshape(b, nc, chunk, h, dd).to(f32)
    kc = k.reshape(b, nc, chunk, h, dd).to(f32)
    vc = v.reshape(b, nc, chunk, h, dd).to(f32)
    lw = logw.reshape(b, nc, chunk, h, dd)
    lcum = torch.cumsum(lw, dim=2)                       # inclusive
    lexc = lcum - lw                                     # exclusive
    # factored intra-chunk: A[t,s] = sum_d r_t e^{lexc_t} * k_s e^{-lcum_s}
    #   valid for s < t;  |exponents| <= chunk * |LOGW_MIN| = 80 < 88 (f32)
    r_dec = rc * torch.exp(lexc)
    k_dec = kc * torch.exp(-lcum)
    amat = torch.einsum("bcthd,bcshd->bchts", r_dec, k_dec)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    amat = amat * mask[None, None, None, :, :]
    diag = torch.einsum("bcthd,hd,bcthd->bcth", rc, u, kc)
    y = torch.einsum("bchts,bcshd->bcthd", amat, vc) + diag[..., None] * vc
    # inter-chunk
    lend = lcum[:, :, -1]                                # (b,c,h,d)
    kin = kc * torch.exp(lend[:, :, None] - lcum)        # decay s -> end
    state_in = torch.einsum("bcshd,bcshe->bchde", kin, vc)
    state = torch.zeros((b, h, dd, dd), dtype=f32, device=r.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(lend[:, c])[..., None] + state_in[:, c]
    prev = torch.stack(prev, dim=1)                      # (b,c,h,dk,dv)
    y = y + torch.einsum("bcthd,bchde->bcthe", r_dec, prev)
    return y.reshape(b, s, h, dd), state


def _group_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 64e-5):
    """Per-head LayerNorm of (B, S, H, D), flattened to (B, S, H*D) f32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    b, s, h, dd = x.shape
    return y.reshape(b, s, h * dd) * w.to(torch.float32)[None, None, :]


def rwkv_time_mix(p, x: torch.Tensor, cfg: ModelConfig, *,
                  prev_token=None, state=None, fake_quant: bool = False):
    """Returns (out, (last token (B, 1, d), new state)).  A prompt
    starts from a zero state; one token with a ``state`` runs the exact
    recurrence."""
    b, s, d = x.shape
    nh = d // HEAD_DIM
    mxp, dt = cfg.mx, x.dtype
    xx = _token_shift(x, prev_token)
    mu = p["mu"].to(dt)
    xr, xk, xv, xw, xg = [x + mu[i][None, None, :] * (xx - x)
                          for i in range(5)]
    r = dense(xr, p["wr"], mxp, fake_quant).reshape(b, s, nh, HEAD_DIM)
    k = dense(xk, p["wk"], mxp, fake_quant).reshape(b, s, nh, HEAD_DIM)
    v = dense(xv, p["wv"], mxp, fake_quant).reshape(b, s, nh, HEAD_DIM)
    g = dense(xg, p["wg"], mxp, fake_quant)
    logw = _decay(p, xw).reshape(b, s, nh, HEAD_DIM)
    u = p["u"]
    if s == 1 and state is not None:
        rf, kf, vf = (t.to(torch.float32)[:, 0] for t in (r, k, v))
        wt = torch.exp(logw.to(torch.float32))[:, 0]      # (B,H,D)
        kv = torch.einsum("bhd,bhe->bhde", kf, vf)
        y = torch.einsum("bhd,bhde->bhe", rf, state + u[None, :, :, None]
                         * kv)
        new_state = state * wt[..., None] + kv
        y = y.reshape(b, 1, nh, HEAD_DIM)
    else:
        chunk = min(CHUNK, s)
        pad = (-s) % chunk
        rp, kp, vp, lp = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, logw))
        if pad:
            lp[:, s:] = LOGW_PAD
        y, new_state = _wkv_chunked(rp, kp, vp, lp, u, chunk)
        y = y[:, :s]
    y = _group_norm(y, p["ln_w"])
    y = (y * F.silu(g.to(torch.float32))).to(dt)
    out = dense(y, p["wo"], mxp, fake_quant)
    return out, (x[:, -1:], new_state)


def rwkv_channel_mix(p, x: torch.Tensor, cfg: ModelConfig, *,
                     prev_token=None, fake_quant: bool = False):
    """Returns (out, last token (B, 1, d))."""
    mxp, dt = cfg.mx, x.dtype
    xx = _token_shift(x, prev_token)
    mu = p["mu"].to(dt)
    xk = x + mu[0][None, None, :] * (xx - x)
    xr = x + mu[1][None, None, :] * (xx - x)
    k = dense(xk, p["wk"], mxp, fake_quant)
    k = torch.square(F.relu(k.to(torch.float32))).to(dt)
    v = dense(k, p["wv"], mxp, fake_quant)
    rgate = torch.sigmoid(dense(xr, p["wr"], mxp, fake_quant)
                          .to(torch.float32)).to(dt)
    return v * rgate, x[:, -1:]


def rwkv_init_state(cfg: ModelConfig, batch: int, device,
                    layers_dim: Tuple[int, ...] = ()):
    """Recurrent state of one block (optionally stacked): the WKV state
    (B, H, D, D) f32 and the last token seen by each mix (B, 1, d)."""
    d = cfg.d_model
    nh = d // HEAD_DIM
    dt = cfg.torch_dtype
    return {
        "tmix_state": torch.zeros(layers_dim + (batch, nh, HEAD_DIM,
                                                HEAD_DIM),
                                  dtype=torch.float32, device=device),
        "tmix_prev": torch.zeros(layers_dim + (batch, 1, d), dtype=dt,
                                 device=device),
        "cmix_prev": torch.zeros(layers_dim + (batch, 1, d), dtype=dt,
                                 device=device),
    }
