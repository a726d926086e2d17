"""internvl2-76b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

Backbone only: 80L d=8192 64H GQA kv=8 d_ff=28672 vocab=128256.  The ViT
frontend is a stub: the batch feeds 256 precomputed patch embeddings as
prefix tokens (the reference's src/repro/configs/internvl2_76b.py, field
for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="decoder",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128, rope_theta=1_000_000.0,
    prefix_len=256, frontend="patch",
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, prefix_len=8, dtype="float32",
        param_dtype="float32", remat=False)
