"""moonshot-v1-16b-a3b [moe] — kimi/moonlight 64e top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L d=2048 16H kv=16, expert d_ff=1408, 2 shared experts, vocab=163840;
layer 0 dense (ff=11264) (the reference's
src/repro/configs/moonshot_v1_16b_a3b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="decoder",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840, head_dim=128,
    n_experts=64, n_shared_experts=2, moe_topk=6, moe_d_ff=1408,
    n_dense_layers=1, capacity_factor=1.25,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32 (as the
    reference's ``load_reduced`` serves it)."""
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, head_dim=32, n_experts=8, n_shared_experts=2, moe_topk=2,
        moe_d_ff=64, n_dense_layers=1, dtype="float32",
        param_dtype="float32", remat=False)
