"""chatglm3-6b [dense] — RoPE 2d (half head-dim), GQA kv=2 [arXiv:2406.12793].

28L d=4096 32H kv=2 d_ff=13696 vocab=65024 (the reference's
src/repro/configs/chatglm3_6b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="decoder",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128, rope_frac=0.5,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32 (as the
    reference's ``load_reduced`` serves it)."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, dtype="float32",
        param_dtype="float32", remat=False)
