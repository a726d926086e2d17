"""Every model family of the reference (``registry.ARCH_IDS``) in
PyTorch: the decoder (GQA, MoE, MLA, the patch frontend), the
encoder-decoder, the Mamba2 hybrid and RWKV6."""
from repro_torch.models.config import (ModelConfig,  # noqa: F401
                                       apply_policy_table)
from repro_torch.models.registry import (ARCH_IDS, Model,  # noqa: F401
                                         batch_specs, decode_specs,
                                         load_config, load_reduced,
                                         make_concrete_batch)
