"""Model configuration of the port's GQA decoder family (dense and MoE).

Mirrors src/repro/models/config.py for the fields the decoder family
uses (the MLA, SSM and encoder-decoder fields are not ported); quantization is one per-tensor-role ``QuantPolicy``
(``repro_torch.core.spec``): weights, kv_key and kv_value each carry an
optional ``QuantSpec``, so INT8 keys can pair with E2M1 values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.spec import QuantPolicy, QuantSpec  # noqa: F401


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
    dtype: str = "bfloat16"        # compute and stored-parameter dtype
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

    def moe_layer(self, i: int) -> bool:
        """Layer ``i`` (absolute, from 0) routes its MLP through experts:
        every layer past the leading ``n_dense_layers`` of an MoE
        config."""
        return self.n_experts > 0 and i >= self.n_dense_layers

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
