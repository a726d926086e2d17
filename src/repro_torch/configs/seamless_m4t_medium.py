"""seamless-m4t-medium [audio] — enc-dec multimodal [arXiv:2308.11596].

12L (12 enc + 12 dec) d=1024 16H MHA d_ff=4096 vocab=256206.  The speech
frontend is a stub: the encoder consumes precomputed frame embeddings (the
reference's src/repro/configs/seamless_m4t_medium.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, head_dim=64, gated_mlp=False, frontend="frames",
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32."""
    return dataclasses.replace(
        CONFIG, n_layers=4, n_enc_layers=2, n_dec_layers=2, d_model=96,
        n_heads=4, n_kv_heads=4, d_ff=192, vocab=512, head_dim=24,
        dtype="float32", param_dtype="float32", remat=False)
