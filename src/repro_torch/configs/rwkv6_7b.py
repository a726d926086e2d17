"""rwkv6-7b [ssm] — Finch, data-dependent decay linear attention
[arXiv:2404.05892].

32L d=4096 (attention-free) d_ff=14336 vocab=65536 (the reference's
src/repro/configs/rwkv6_7b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, head_dim=64,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=64, dtype="float32", param_dtype="float32",
        remat=False)
