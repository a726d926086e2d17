"""glm4-9b [dense] — RoPE (half), GQA kv=2 [hf:THUDM/glm-4-9b].

40L d=4096 32H kv=2 d_ff=13696 vocab=151552 (the reference's
src/repro/configs/glm4_9b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="decoder",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, head_dim=128, rope_frac=0.5,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32 (as the
    reference's ``load_reduced`` serves it)."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, dtype="float32",
        param_dtype="float32", remat=False)
