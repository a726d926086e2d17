"""Decoder-only LM: dense GQA, MoE, MLA (deepseek-v2) and the patch
frontend's prefix embeddings (internvl2) (mirrors
src/repro/models/decoder.py).

The reference stacks layers and drives them with ``lax.scan`` after a
list of an MoE config's leading dense layers; here ``params["layers"]``
is one list of ``n_layers`` per-layer dicts (the dense layers first: an
``"mlp"``, an MoE layer a ``"moe"`` with its router, expert stacks and
shared experts) walked by a Python loop, each layer under its own config
``cfg.layer_cfg(i)`` (a per-layer ``PolicyTable`` gives each layer its
weight and KV formats).  Caches and page pools stay layer-stacked on a
leading axis (as in the reference), one stack per KV group
(``layers.kv_groups``: the layers sharing KV specs; a uniform policy is
one group), and each layer reads its slice, a contiguous view.  The
fused decode window (the reference's jitted
``lax.scan``) is ``paged_decode_window_step`` repeated: here as a Python
loop (``paged_decode_multi_step``, what a CPU tensor runs), on the card
as one captured CUDA graph replayed once per step
(``repro_torch.serve.graphs``).  Either way sampling keys, lengths,
budgets and the health flag stay on the device, and nothing in a step
waits for the host.  ``forward`` is the training forward (QAT through
``fake_quant``; each layer recomputed in the backward under
``cfg.remat``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mx_weight import MXWeight
from repro_torch.dist.sharding import (fsdp_gather, model_copy,
                                       model_gather, model_index,
                                       model_parts, model_sum,
                                       wgather_parts)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

VOCAB_PAD = 512

# matmul weight leaves quantized by ``quantize_weights`` — all (K, N), or
# (E, K, N) expert stacks; the router, norms, the embedding and the LM
# head stay fp
_WEIGHT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3"})


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


# =============================================================================
# parameters
# =============================================================================
def seeded_generator(device, seed: int) -> Optional[torch.Generator]:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on
    the meta device (no data: the shapes alone, for a cell's stand-ins),
    which has no generator."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def normal_init(gen: Optional[torch.Generator], shape, std: float, dtype,
                device):
    """N(0, std^2) in f32 from ``gen``, stored in ``dtype`` (as the
    reference's ``dense_init``/``embed_init``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def _layer_init(gen, cfg: ModelConfig, device,
                moe_layer: bool) -> Dict[str, Any]:
    """One layer's weights (the reference's ``_layer_init``): attention
    (GQA, or MLA's ``mla_init``), then an MLP of ``d_ff`` or, on an MoE
    layer, the reference's ``moe_init``: an f32 router, (E, d, ff) /
    (E, ff, d) expert stacks of ``moe_d_ff`` and gated shared experts of
    ``moe_d_ff * n_shared_experts``."""
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype

    def dense_init(d_in, d_out, lead=(), dtype=dt):
        return normal_init(gen, lead + (d_in, d_out),
                           1.0 / np.sqrt(d_in), dtype, device)

    def mlp_init(ff, gated):
        w = {"w1": dense_init(d, ff)}
        if gated:
            w["w3"] = dense_init(d, ff)
        w["w2"] = dense_init(ff, d)
        return w

    p = {"ln1": torch.ones(d, dtype=dt, device=device),
         "ln2": torch.ones(d, dtype=dt, device=device)}
    if cfg.mla:
        dq, qk = cfg.q_lora or d, cfg.qk_nope_dim + cfg.qk_rope_dim
        a = {"w_dkv": dense_init(d, cfg.kv_lora),
             "w_kr": dense_init(d, cfg.qk_rope_dim),
             "w_uk": dense_init(cfg.kv_lora, nh * cfg.qk_nope_dim),
             "w_uv": dense_init(cfg.kv_lora, nh * cfg.v_head_dim),
             "wo": dense_init(nh * cfg.v_head_dim, d),
             "kv_norm": torch.ones(cfg.kv_lora, dtype=dt, device=device)}
        if cfg.q_lora:
            a["w_dq"] = dense_init(d, dq)
            a["q_norm"] = torch.ones(dq, dtype=dt, device=device)
        a["w_uq"] = dense_init(dq, nh * qk)
        p["attn"] = a
    else:
        p["attn"] = {"wq": dense_init(d, nh * hd),
                     "wk": dense_init(d, nkv * hd),
                     "wv": dense_init(d, nkv * hd),
                     "wo": dense_init(nh * hd, d)}
    if not moe_layer:
        p["mlp"] = mlp_init(cfg.d_ff, cfg.gated_mlp)
        return p
    e, ff = (cfg.n_experts,), cfg.moe_d_ff
    p["moe"] = {"router": dense_init(d, cfg.n_experts, dtype=torch.float32),
                "experts": {"w1": dense_init(d, ff, e),
                            "w3": dense_init(d, ff, e),
                            "w2": dense_init(ff, d, e)}}
    if cfg.n_shared_experts:
        p["moe"]["shared"] = mlp_init(ff * cfg.n_shared_experts, True)
    return p


def _quantize_layer_tree(lp, spec):
    """MXWeight-quantize every matmul weight leaf of one layer (None spec
    keeps the layer fp)."""
    if spec is None:
        return lp
    out = {}
    for key, val in lp.items():
        if isinstance(val, dict):
            out[key] = _quantize_layer_tree(val, spec)
        elif key in _WEIGHT_KEYS:
            out[key] = MXWeight.quantize(val, spec)
        else:
            out[key] = val
    return out


@functools.lru_cache(maxsize=64)
def layer_cfgs(cfg: ModelConfig) -> Tuple[ModelConfig, ...]:
    """Each layer's uniform config (``cfg`` itself without a table)."""
    return tuple(cfg.layer_cfg(i) for i in range(cfg.n_layers))


def _refuse_mla_weights(cfg: ModelConfig) -> None:
    if cfg.mla:
        raise NotImplementedError(
            "weight-resident storage covers the GQA decoder family "
            "(MLA projections are not routed through MXWeight yet)")


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         quantize: bool = False, place=None) -> Dict[str, Any]:
    """Random weights on ``device`` from a seeded ``torch.Generator``,
    layer by layer: the embedding at 0.02 std, projections at
    1/sqrt(fan_in) (the reference's ``embed_init``/``dense_init``).  With
    ``quantize`` each layer is converted to weight-resident MXWeight
    storage (its own policy's ``weights``; a layer without one stays fp)
    as soon as it is made, so the fp weights of only one layer exist at
    a time.  MLA refuses ``quantize``, as the reference's
    ``quantize_weights`` does.  ``place`` (a sharded rank's
    ``dist.sharding.shard_params`` over its mesh) is applied to each
    piece of the tree as soon as it is made (and quantized): the rank
    keeps only its shard, and the random draws are those of the whole
    model, so the shards are slices of the unsharded weights."""
    if quantize:
        _refuse_mla_weights(cfg)
    device = torch.device(device)
    gen = seeded_generator(device, seed)
    if place is None:
        def place(tree):
            return tree
    vp, d, dt = padded_vocab(cfg), cfg.d_model, cfg.torch_dtype
    params: Dict[str, Any] = place(
        {"embed": normal_init(gen, (vp, d), 0.02, dt, device)})
    params["layers"] = []
    for i in range(cfg.n_layers):
        lp = _layer_init(gen, cfg, device, cfg.moe_layer(i))
        if quantize:
            lp = _quantize_layer_tree(lp, cfg.layer_policy(i).weights)
        params["layers"].append(place({"layers": [lp]})["layers"][0])
    params["norm_f"] = torch.ones(d, dtype=dt, device=device)
    if not cfg.tie_embeddings:
        params.update(place({"lm_head": normal_init(
            gen, (d, vp), 1.0 / np.sqrt(d), dt, device)}))
    return params


def quantize_weights(params, cfg: ModelConfig):
    """Convert every layer's matmul weights to weight-resident MXWeight
    storage per its own policy's ``weights`` (a layer without one stays
    fp); MLA raises, as in the reference."""
    _refuse_mla_weights(cfg)
    out = dict(params)
    out["layers"] = [_quantize_layer_tree(lp, cfg.layer_policy(i).weights)
                     for i, lp in enumerate(params["layers"])]
    return out


# =============================================================================
# forward pieces
# =============================================================================
def embed(params, cfg: ModelConfig, tokens: torch.Tensor,
          prefix_embeds=None) -> torch.Tensor:
    """Token embeddings; ``prefix_embeds`` (B, P, d), the patch
    frontend's precomputed embeddings, go before them.  Under a mesh the
    table is vocab-sharded over "model" (``param_specs``): each rank
    looks up the tokens of its rows, zeros elsewhere, and the f32 sum
    over "model" is each token's one row, exactly (its gradient reaches
    each rank's rows unchanged).  Under the FSDP posture the table's
    "data"-split d dim is gathered first (``fsdp_gather``)."""
    w = params["embed"]
    if wgather_parts(cfg.d_model) > 1:
        w = fsdp_gather(w, 1)
    if model_parts(padded_vocab(cfg)) > 1:
        vl = w.shape[0]
        t = tokens.to(torch.int64) - model_index() * vl
        mine = (t >= 0) & (t < vl)
        rows = w[t.clamp(0, vl - 1)].to(torch.float32)
        x = model_sum(torch.where(mine[..., None], rows, 0.0))
        x = x.to(cfg.torch_dtype)
    else:
        x = w[tokens.to(torch.int64)].to(cfg.torch_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


class _HeadMM(torch.autograd.Function):
    """x (N, d) bf16 @ head (d, V) bf16 -> f32 logits as one GEMM on the
    card.  Backward: the logits' f32 gradient is rounded to bf16 and both
    products run as bf16 GEMMs with f32 accumulation (the reference's
    transpose contracts that gradient in f32; the rounding is the usual
    mixed-precision one, 2^-9 relative per element)."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return torch.mm(x, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, head = ctx.saved_tensors
        g = grad.to(torch.bfloat16)
        dx = g @ head.T if ctx.needs_input_grad[0] else None
        dh = x.T @ g if ctx.needs_input_grad[1] else None
        return dx, dh


def head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head; f32 logits (the reference contracts in the
    activation dtype with an f32 accumulator and keeps f32 output).  A
    bf16 x bf16 head on the card is one bf16-input, f32-output GEMM that
    reads the head's bf16 bytes once (``_HeadMM``); elsewhere both sides
    widen to f32.  Products of bf16 values are exact in f32, so the two
    differ only in summation order."""
    return head_logits(params, L.rms_norm(x, params["norm_f"],
                                          cfg.norm_eps),
                       vocab=padded_vocab(cfg))


def head_logits(params, x: torch.Tensor,
                vocab: Optional[int] = None) -> torch.Tensor:
    """x (..., d) @ the LM head (the tied embedding without one) -> f32
    logits (..., Vp); see ``head``.  Under a mesh the head of ``vocab``
    (the padded vocabulary) columns is vocab-sharded, column-parallel:
    the rank's columns are gathered over "model" before anything samples
    from them (x enters through ``model_copy``; backward, each rank takes
    its columns' gradient of the logits, which every rank computes
    alike).  Under the FSDP posture the head's "data"-split d dim is
    gathered first (``fsdp_gather``)."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"]
        if wgather_parts(x.shape[-1]) > 1:
            w = fsdp_gather(w, 1)
        w = w.T
    elif wgather_parts(x.shape[-1]) > 1:
        w = fsdp_gather(w, 0)
    split = vocab is not None and model_parts(vocab) > 1
    if split:
        x = model_copy(x)
    if x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16:
        lead = x.shape[:-1]
        out = _HeadMM.apply(x.reshape(-1, x.shape[-1]), w)
        out = out.reshape(lead + (w.shape[-1],))
    else:
        out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if split:
        out = model_gather(out, -1)
    return out


def _block(i: int, lp, x, cfg: ModelConfig, *, positions=None, cache=None,
           cache_pos: int = 0, paged=None, paged_prefill=None, tap=None,
           fake_quant: bool = False):
    """Layer ``i`` under its config ``cfg``: attention (over the cache or
    pages given), then the MLP or, on an MoE layer, ``moe``.  Returns (x,
    cache, aux): ``aux`` the MoE load-balance loss (None on a dense
    layer).  ``tap`` (calibration) receives the post-RoPE k/v and, as
    ``activations``, the two post-norm matmul inputs along the sequence
    axis.  ``fake_quant`` (training, the full causal forward) goes to
    every projection."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla:
        if cache is not None and x.shape[1] == 1:
            a, cache = L.mla_decode(lp["attn"], h, cfg, cache=cache,
                                    cache_pos=cache_pos,
                                    fake_quant=fake_quant)
        else:
            a, cache = L.mla_attention(lp["attn"], h, cfg,
                                       positions=positions, cache=cache,
                                       cache_pos=cache_pos,
                                       fake_quant=fake_quant)
    elif paged_prefill is not None:
        block_tables, starts, prompt_lens = paged_prefill
        a, cache = L.attention_paged_prefill(
            lp["attn"], h, cfg, pool=cache, block_tables=block_tables,
            starts=starts, prompt_lens=prompt_lens)
    elif paged is not None:
        block_tables, lengths = paged
        a, cache = L.attention_paged_decode(
            lp["attn"], h, cfg, pool=cache, block_tables=block_tables,
            lengths=lengths)
    else:
        a, cache = L.attention(lp["attn"], h, cfg, positions=positions,
                               cache=cache, cache_pos=cache_pos, tap=tap,
                               fake_quant=fake_quant)
    x = x + a
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if tap is not None:
        tap["activations"] = torch.cat([h, h2], dim=1)
    if cfg.moe_layer(i):
        m, aux = L.moe(lp["moe"], h2, cfg, fake_quant)
        return x + m, cache, aux
    return x + L.mlp(lp["mlp"], h2, cfg, fake_quant), cache, None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Contiguous caches, one stack per KV group (L_g, B, max_len, n_kv,
    X), n_kv the KV heads of the rank under an installed mesh
    (``layers.kv_heads``); MLA's compressed caches (L_g, B, max_len,
    X)."""
    if cfg.mla:
        return L.grouped_kv(cfg, lambda c, ld: L.init_mla_cache(
            c, batch, max_len, device, layers_dim=ld))
    return L.grouped_kv(cfg, lambda c, ld: L.init_kv_cache(
        c, batch, max_len, L.kv_heads(c), c.hd, device, layers_dim=ld))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device):
    """Page pools, one stack per KV group (L_g, num_pages, page_size,
    n_kv, X), each sized by its group's specs.  MLA keeps the contiguous
    layout, as in the reference."""
    if cfg.mla:
        raise NotImplementedError(
            "paged KV serving covers the GQA decoder family; the MLA "
            "compressed cache keeps the contiguous layout")
    return L.grouped_kv(cfg, lambda c, ld: L.init_paged_kv_cache(
        c, num_pages, page_size, L.kv_heads(c), c.hd, device,
        layers_dim=ld))


def _mean_aux(auxs, device) -> torch.Tensor:
    """The mean of per-layer load-balance losses, 0 for a dense layer."""
    if not auxs:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack([torch.zeros((), dtype=torch.float32, device=device)
                        if a is None else a for a in auxs]).mean()


def _forward_with_aux(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                      prefix_embeds=None, fake_quant: bool = False,
                      remat: bool = False):
    """Full causal forward over tokens (B, S) with no cache; returns
    (logits (B, S, Vp) f32, aux): the MoE load-balance loss averaged over
    the layers past the leading dense ones, as the reference's training
    ``forward`` averages its scanned stack (0 for a dense config).  With
    ``remat`` each of those layers runs under
    ``L.checkpointed`` (the reference checkpoints its scan step, and its
    leading dense layers run outside the scan).
    ``prefix_embeds`` (B, P, d) go before the tokens' embeddings (the
    logits cover both)."""
    x = embed(params, cfg, tokens, prefix_embeds)
    positions = L.positions(*x.shape[:2], x.device)
    cfgs, auxs = layer_cfgs(cfg), []
    for i, lp in enumerate(params["layers"]):
        def layer(x, i=i, lp=lp):
            y, _, aux = _block(i, lp, x, cfgs[i], positions=positions,
                               fake_quant=fake_quant)
            return y, aux

        x, aux = L.checkpointed(layer, x,
                                remat and i >= cfg.n_dense_layers)
        if i >= cfg.n_dense_layers:
            auxs.append(aux)
    return head(params, cfg, x), _mean_aux(auxs, x.device)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefix_embeds=None, fake_quant: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward (the reference's ``forward``): tokens (B, S) ->
    (logits (B, S, Vp) f32, aux), each layer recomputed in the backward
    pass when ``cfg.remat``; ``fake_quant`` applies the policy's
    ``weights`` / ``activations`` roles (QAT) through the converter
    kernel, each layer under its own ``layer_cfg(i)``."""
    return _forward_with_aux(params, tokens, cfg,
                             prefix_embeds=prefix_embeds,
                             fake_quant=fake_quant, remat=cfg.remat)


def forward_calib(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  prefix_embeds=None):
    """Instrumented forward for calibration (the reference's
    ``forward_calib``): per layer, the tensors each quantizable role
    would see, unquantized whatever ``cfg.mx`` says: ``activations`` (the
    two post-norm matmul inputs concatenated along the sequence axis),
    and the post-RoPE ``kv_key`` / ``kv_value`` projections.  Returns
    (logits, aux, taps) with ``taps[role][layer]``; aux is averaged over
    every layer, dense ones included, as the reference's ``forward_calib``
    averages it (its training ``forward`` skips them).  MLA raises, as
    in the reference: its compressed cache has no per-head K/V."""
    if cfg.mla:
        raise NotImplementedError(
            "forward_calib covers the GQA decoder family; the MLA "
            "compressed cache has no per-head K/V tensors to calibrate")
    x = embed(params, cfg, tokens, prefix_embeds)
    positions = L.positions(*x.shape[:2], x.device)
    taps = {"activations": [], "kv_key": [], "kv_value": []}
    cfgs, auxs = layer_cfgs(cfg), []
    for i, lp in enumerate(params["layers"]):
        tap = {}
        x, _, aux = _block(i, lp, x, cfgs[i], positions=positions, tap=tap)
        taps["activations"].append(tap["activations"])
        taps["kv_key"].append(tap["k"])
        taps["kv_value"].append(tap["v"])
        auxs.append(aux)
    return head(params, cfg, x), _mean_aux(auxs, x.device), taps


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: int, prefix_embeds=None, cache=None):
    """Process the prompts, fill a contiguous cache at [0, S); returns
    (logits (B, S, Vp) f32, cache, S).  ``prefix_embeds`` (B, P, d) go
    before the tokens (S counts both: decode starts at P + tokens).
    ``cache`` (``init_cache``'s layout for this batch and ``max_len``) is
    zeroed and filled in place instead of a fresh one: a captured decode
    step keeps reading the same buffers."""
    x = embed(params, cfg, tokens, prefix_embeds)
    b, s = x.shape[:2]
    if cache is None:
        cache = init_cache(cfg, b, max_len, x.device)
    else:
        for leaf in cache.values():
            if leaf.shape[1:3] != (b, max_len):
                raise ValueError(f"prefill: a cache leaf {tuple(leaf.shape)}"
                                 f" is not for batch {b} and max_len "
                                 f"{max_len}")
            leaf.zero_()
    positions = L.positions(b, s, x.device)
    cfgs = layer_cfgs(cfg)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _block(i, lp, x, cfgs[i], positions=positions,
                         cache=L.kv_layer_view(cache, cfg, i))
    return head(params, cfg, x), cache, s


def decode_step(params, token: torch.Tensor, cache, pos,
                cfg: ModelConfig):
    """One decode step over the contiguous cache: token (B,) int32 sits at
    position ``pos`` (the cache length so far) and attends positions <=
    pos.  ``pos`` is a host int or a one-element int32 tensor on the
    device (as the reference's traced scalar), which a captured step
    advances on the device; the two give the same logits bit for bit.
    Returns (logits (B, 1, Vp) f32, cache) — the cache is updated in
    place."""
    x = embed(params, cfg, token[:, None])
    positions = L.positions(x.shape[0], 1, x.device, pos)
    cfgs = layer_cfgs(cfg)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _block(i, lp, x, cfgs[i], positions=positions,
                         cache=L.kv_layer_view(cache, cfg, i),
                         cache_pos=pos)
    return head(params, cfg, x), cache


def scatter_prefill(cfg: ModelConfig, pool, cache, page_ids):
    """Scatter a batched contiguous prefill cache into the page pools (in
    place), group by group, packing sub-byte codes per the group's
    specs."""
    for g in L.kv_groups(cfg):
        L.paged_cache_scatter(L.group_leaves(pool, g),
                              L.group_leaves(cache, g), page_ids, g.cfg)
    return pool


def copy_pool_pages(pool, src: torch.Tensor, dst: torch.Tensor):
    """Copy page contents src[i] -> dst[i] in every layer-stacked pool leaf
    (L_g, P, page, n_kv, X) of every KV group, in place (the copy-on-write
    fork under prefix sharing).  The bytes copy verbatim whatever the
    layer's spec, so MX and fp pools alike; the leaves stay the tensors a
    captured decode step reads."""
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    for leaf in pool.values():
        leaf.index_copy_(1, dst, leaf.index_select(1, src))
    return pool


def paged_prefill_suffix(params, tokens: torch.Tensor, starts: torch.Tensor,
                         prompt_lens: torch.Tensor, pool,
                         block_tables: torch.Tensor, cfg: ModelConfig):
    """Prefill only the *uncached suffix* of G prompts over the paged KV
    cache (prefix sharing): request g's tokens cover prompt positions
    [starts[g], prompt_lens[g]), padded on the right; earlier positions
    are already in the slot's (shared, read-only) prefix pages.

    tokens (G, S) int32; starts / prompt_lens (G,) int32; block_tables
    (G, max_pages) int32, the slots' full rows with any copy-on-write
    fork applied.  Returns (logits (G, S, Vp) f32, pool), the pool
    written in place; logits row i of request g is prompt position
    starts[g] + i (the engine samples at prompt_lens - starts - 1)."""
    x = embed(params, cfg, tokens)
    paged_prefill = (block_tables, starts, prompt_lens)
    cfgs = layer_cfgs(cfg)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _block(i, lp, x, cfgs[i],
                         cache=L.kv_layer_view(pool, cfg, i),
                         paged_prefill=paged_prefill)
    return head(params, cfg, x), pool


def paged_decode_step(params, token: torch.Tensor, pool, block_tables,
                      lengths, cfg: ModelConfig):
    """One continuous-batching decode step over the paged KV cache.
    token (B,) int32; block_tables (B, max_pages) int32; lengths (B,)
    int32 (slot b's token sits at position lengths[b]).  Returns (logits
    (B, 1, Vp) f32, pool) — the pool is updated in place."""
    x = embed(params, cfg, token[:, None])
    paged = (block_tables, lengths)
    cfgs = layer_cfgs(cfg)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _block(i, lp, x, cfgs[i],
                         cache=L.kv_layer_view(pool, cfg, i), paged=paged)
    return head(params, cfg, x), pool


# =============================================================================
# sampling: counter-based per-slot keys
# =============================================================================
_LANE = 0xFFFFFFFF
# odd multipliers below 2^31: a 32-bit lane times one stays below 2^63, so
# no product overflows int64 on any device
_MUL = (0x7FEB352D, 0x68E31DA5)


def mix32(x):
    """A 32-bit integer hash (the "lowbias32" shift-multiply sequence with
    multipliers below 2^31), on a Python int or an int64 tensor of 32-bit
    lanes; the same bits either way."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _LANE
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _LANE
    return x ^ (x >> 16)


def request_keys(seeds: torch.Tensor) -> torch.Tensor:
    """Sampling keys (G, 2) int64 of G requests from their 32-bit stream
    seeds (``serve.scheduler.request_seed``): [stream, steps so far]."""
    seeds = seeds.to(torch.int64) & _LANE
    return torch.stack([seeds, torch.zeros_like(seeds)], dim=1)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: float):
    """Sample one token per slot on the device.

    logits (B, vocab) f32; keys (B, 2) int64, one counter-based key per
    slot: [stream, steps so far].  The keys advance every call whatever
    the temperature (the reference splits its keys every call), so a
    slot's draws depend only on its stream and its own step count — not
    on the batch, its slot or the decode window — and a window of any
    length gives the per-step loop's tokens.  Greedy (temperature <= 0)
    is the first maximal index, as the reference's argmax.  Otherwise a
    Gumbel-max draw over ``logits / temperature`` in f32: each (slot,
    vocab entry) hashes its stream, step and index into 23 uniform bits,
    u in (0, 1), and adds -log(-log u).  No ``torch.Generator`` is read,
    so the step can be captured in a CUDA graph.  Returns (new keys,
    tokens (B,) int32)."""
    new_keys = torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1)
    if temperature <= 0.0:
        return new_keys, torch.argmax(logits, dim=-1).to(torch.int32)
    sub = mix32(mix32(keys[:, 0]) ^ (keys[:, 1] & _LANE))
    idx = mix32(torch.arange(logits.shape[-1], dtype=torch.int64,
                             device=logits.device))
    bits = mix32(sub[:, None] ^ idx[None, :]) >> 9
    # (k + 1/2) / 2^23 is exact in f32 and lies in [2^-24, 1 - 2^-24]:
    # never 0 or 1, so the Gumbel noise is finite
    u = (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    gumbel = -torch.log(-torch.log(u))
    nxt = torch.argmax(logits.to(torch.float32) / temperature + gumbel,
                       dim=-1)
    return new_keys, nxt.to(torch.int32)


def paged_decode_window_step(params, token, pool, block_tables, lengths,
                             remaining, keys, cfg: ModelConfig, *,
                             temperature: float = 0.0, trash_page: int = 0,
                             health: bool = False):
    """One step of the fused decode window (the body of the reference's
    scan, ``one()``).

    A slot whose budget is spent is masked: its block-table row points at
    ``trash_page``, its length reads 0 and its token, length and budget
    freeze, so over-generated steps never touch live pages.  Returns
    (token, lengths, remaining, keys, bad): ``bad`` (B,) bool flags a slot
    whose logits went non-finite at an active step (None without
    ``health``; the finite-logits half of the numeric-health guard)."""
    done = remaining <= 0
    bt = torch.where(done[:, None], trash_page, block_tables)
    ln = torch.where(done, 0, lengths)
    logits, pool = paged_decode_step(params, token, pool, bt, ln, cfg)
    last = logits[:, -1, :cfg.vocab]
    keys, nxt = sample_tokens(last, keys, temperature)
    bad = (~torch.isfinite(last).all(dim=-1) & ~done) if health else None
    token = torch.where(done, token, nxt)
    lengths = torch.where(done, lengths, lengths + 1)
    remaining = torch.where(done, remaining, remaining - 1)
    return token, lengths, remaining, keys, bad


def paged_decode_multi_step(params, token, pool, block_tables, lengths,
                            remaining, keys, cfg: ModelConfig, *,
                            n_steps: int, temperature: float = 0.0,
                            trash_page: int = 0, health: bool = False):
    """``n_steps`` decode steps on the device — the hot loop, eagerly.

    Tokens, lengths, remaining budgets and sampling keys stay on the
    device across the window (``paged_decode_window_step`` each step);
    the caller moves the tokens to the host once per window.  Returns
    (tokens (n_steps, B) int32, pool, lengths, remaining, keys), plus,
    with ``health``, a (B,) bool flagging slots whose logits went
    non-finite at any active step of the window."""
    toks: List[torch.Tensor] = []
    bad = torch.zeros(token.shape, dtype=torch.bool, device=token.device)
    for _ in range(n_steps):
        token, lengths, remaining, keys, b = paged_decode_window_step(
            params, token, pool, block_tables, lengths, remaining, keys,
            cfg, temperature=temperature, trash_page=trash_page,
            health=health)
        if health:
            bad = bad | b
        toks.append(token)
    out = (torch.stack(toks), pool, lengths, remaining, keys)
    return out + (bad,) if health else out
