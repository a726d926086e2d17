"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d=5120 128H, expert d_ff=1536, vocab=102400; layer 0 dense (ff=12288);
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128 (the
reference's src/repro/configs/deepseek_v2_236b.py, field for field).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="decoder",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    n_experts=160, n_shared_experts=2, moe_topk=6, moe_d_ff=1536,
    n_dense_layers=1, capacity_factor=1.25,
    mla=True, q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
)


def reduced() -> ModelConfig:
    """The reference's reduced config for CPU tests, in f32 (as the
    reference's ``load_reduced`` serves it)."""
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, n_experts=8, n_shared_experts=1, moe_topk=2, moe_d_ff=64,
        n_dense_layers=1, q_lora=48, kv_lora=32, qk_nope_dim=32,
        qk_rope_dim=16, v_head_dim=32, dtype="float32",
        param_dtype="float32", remat=False)
