"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652].

60L d=7168 56H kv=8 d_ff=20480 vocab=64000 (the reference's
src/repro/configs/yi_34b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="decoder",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128, rope_theta=5_000_000.0,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32 (as the
    reference's ``load_reduced`` serves it)."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=112, n_heads=7, n_kv_heads=1, d_ff=224,
        vocab=512, head_dim=16, dtype="float32",
        param_dtype="float32", remat=False)
