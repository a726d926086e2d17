"""Model configuration of the port's GQA decoder family (dense and MoE).

Mirrors src/repro/models/config.py for the fields the decoder family
uses (the MLA, SSM and encoder-decoder fields are not ported);
quantization is a per-tensor-role ``QuantPolicy``
(``repro_torch.core.spec``): weights, kv_key and kv_value each carry an
optional ``QuantSpec``, so INT8 keys can pair with E2M1 values.  A
per-layer ``PolicyTable`` (``apply_policy_table``) gives each layer its
own policy: ``layer_cfg(i)`` is layer ``i``'s uniform view.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.spec import (PolicyTable, QuantPolicy,  # noqa: F401
                                   QuantSpec)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "decoder" (the only family ported)
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
