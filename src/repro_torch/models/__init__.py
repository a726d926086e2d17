"""The GQA decoder family (dense and MoE; ``registry.ARCH_IDS``) in
PyTorch."""
from repro_torch.models.config import (ModelConfig,  # noqa: F401
                                       apply_policy_table)
from repro_torch.models.registry import (ARCH_IDS, Model,  # noqa: F401
                                         load_config, load_reduced)
