"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attn block
[arXiv:2411.15242].

38L d=2048 32H(kv=32, head 64) d_ff=8192 vocab=32000 ssm_state=64.
The shared attention+MLP block (one weight set) is invoked every 2 Mamba2
layers (19 invocation sites, each with its own KV cache; the reference's
src/repro/configs/zamba2_1p2b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, head_dim=64, ssm_state=64, ssm_expand=2, d_conv=4,
    attn_every=2,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32."""
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=64, ssm_state=16, attn_every=2, dtype="float32",
        param_dtype="float32", remat=False)
