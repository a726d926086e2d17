"""Model configuration of every family the port serves (mirrors
src/repro/models/config.py field for field, but for the reference's
dry-run switch ``scan_unroll``): the GQA decoders, dense and MoE, with
MLA (deepseek-v2) and a patch frontend's prefix (internvl2); the Mamba2
hybrid (zamba2); RWKV6; the encoder-decoder (seamless). Quantization is
a per-tensor-role ``QuantPolicy`` (``repro_torch.core.spec``): weights,
kv_key and kv_value each carry an optional ``QuantSpec``, so INT8 keys
can pair with E2M1 values. A per-layer ``PolicyTable``
(``apply_policy_table``) gives each layer its own policy:
``layer_cfg(i)`` is layer ``i``'s uniform view.  ``ShapeSpec`` and
``SHAPES`` are the reference's cells' input shapes
(``launch/cells.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.spec import (PolicyTable, QuantPolicy,  # noqa: F401
                                   QuantSpec)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # decoder | encdec | hybrid | rwkv
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_frac: float = 1.0         # chatglm3 rotates half the head dim
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    gated_mlp: bool = True         # SwiGLU vs plain GELU
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    n_dense_layers: int = 0        # leading dense layers before the MoE ones
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    d_conv: int = 4
    attn_every: int = 0            # zamba2: shared attn block period
    # --- enc-dec ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- modality frontend stubs ---
    prefix_len: int = 0            # internvl2: ViT patch tokens (stub embeds)
    frontend: str = "none"         # none | patch | frames
    mx: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)
    # per-layer policy table; set only through ``apply_policy_table``, so
    # an all-layers-identical table collapses to ``mx`` (today's path).
    # When set, ``mx`` mirrors the table's default.
    mx_table: Optional[PolicyTable] = None
    dtype: str = "bfloat16"        # compute and stored-parameter dtype
    # the dtype AdamW casts its f32 master weights to after each step
    # (training; the reference's ``param_dtype``)
    param_dtype: str = "bfloat16"
    # training: recompute each layer's activations in the backward pass
    # (``torch.utils.checkpoint``) instead of keeping them
    remat: bool = True
    # "dense" | "flash": "flash" sends MX decode attention (contiguous and
    # paged) and the causal fp prefill through their kernels; "dense"
    # attends in plain torch everywhere (the reference's default)
    attn_impl: str = "dense"

    def __post_init__(self):
        if self.attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be 'dense' or 'flash', got "
                             f"{self.attn_impl!r}")

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    def layer_policy(self, i: int) -> QuantPolicy:
        """The quantization policy of absolute layer ``i``."""
        if self.mx_table is None:
            return self.mx
        return self.mx_table.layer(i)

    def layer_cfg(self, i: int) -> "ModelConfig":
        """A uniform-policy view of this config for layer ``i``: what the
        layer functions are handed."""
        if self.mx_table is None:
            return self
        return dataclasses.replace(self, mx=self.mx_table.layer(i),
                                   mx_table=None)

    def moe_layer(self, i: int) -> bool:
        """Layer ``i`` (absolute, from 0) routes its MLP through experts:
        every layer past the leading ``n_dense_layers`` of an MoE
        config."""
        return self.n_experts > 0 and i >= self.n_dense_layers

    def param_count(self) -> int:
        """Analytic parameter count (the reference's, branch for branch)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv":
            per = 4 * d * d + 2 * d * self.d_ff + 10 * d  # tmix + cmix
            return emb + self.n_layers * per
        if self.family == "hybrid":
            din = self.ssm_expand * d
            per = d * (2 * din + 2 * self.ssm_state + din // 64) + din * d \
                + din * self.d_conv
            attn = 4 * d * d + 3 * d * self.d_ff
            return emb + self.n_layers * per + attn  # shared attn once
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        if self.mla:
            dq = self.q_lora or d
            attn = d * dq + dq * nh * (self.qk_nope_dim + self.qk_rope_dim) \
                + d * (self.kv_lora + self.qk_rope_dim) \
                + self.kv_lora * nh * (self.qk_nope_dim + self.v_head_dim) \
                + nh * self.v_head_dim * d
        else:
            attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp_mult = 3 if self.gated_mlp else 2
        dense_mlp = mlp_mult * d * self.d_ff
        if self.n_experts:
            expert = mlp_mult * d * self.moe_d_ff
            moe_mlp = self.n_experts * expert \
                + self.n_shared_experts * expert + d * self.n_experts
            n_moe = self.n_layers - self.n_dense_layers
            mlp_total = self.n_dense_layers * dense_mlp + n_moe * moe_mlp
        else:
            mlp_total = self.n_layers * dense_mlp
        n_l = self.n_layers if self.family != "encdec" \
            else self.n_enc_layers + self.n_dec_layers
        layers = n_l * attn + mlp_total
        if self.family == "encdec":
            layers += self.n_dec_layers * attn  # cross-attention
        return emb + layers

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (SSM/hybrid/linear)."""
        return self.family in ("hybrid", "rwkv")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def apply_policy_table(cfg: ModelConfig, table) -> ModelConfig:
    """Install a per-layer ``PolicyTable`` (or a plain ``QuantPolicy``) on
    a config.  An all-layers-identical table collapses to its default
    ``QuantPolicy`` with ``mx_table=None``, the config the uniform policy
    builds; a table may not name a layer past ``n_layers``."""
    if isinstance(table, QuantPolicy):
        return dataclasses.replace(cfg, mx=table, mx_table=None)
    if not isinstance(table, PolicyTable):
        raise TypeError(f"expected a PolicyTable or QuantPolicy, got "
                        f"{type(table).__name__}")
    collapsed = table.collapse()
    if isinstance(collapsed, QuantPolicy):
        return dataclasses.replace(cfg, mx=collapsed, mx_table=None)
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"{cfg.name}: per-layer policy tables cover the decoder "
            f"family; {cfg.family!r} models take a uniform QuantPolicy")
    bad = [i for i, _ in table.overrides if i >= cfg.n_layers]
    if bad:
        raise ValueError(
            f"{cfg.name}: policy table names layer(s) {bad} but the "
            f"model has {cfg.n_layers} layers (indices 0.."
            f"{cfg.n_layers - 1})")
    return dataclasses.replace(cfg, mx=table.default, mx_table=table)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell (``launch/cells.py``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """long_500k only for sub-quadratic archs (the reference's rule)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)
