"""deepseek-67b [dense] — llama-arch GQA [arXiv:2401.02954].

95L d=8192 64H kv=8 d_ff=22016 vocab=102400 (the reference's
src/repro/configs/deepseek_67b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="decoder",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=102400, head_dim=128,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32 (as the
    reference's ``load_reduced`` serves it)."""
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, dtype="float32",
        param_dtype="float32", remat=False)
