"""Model configuration of the port's dense GQA decoder family.

Mirrors src/repro/models/config.py for the fields the decoder family
uses; quantization is one per-tensor-role ``QuantPolicy``
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

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
