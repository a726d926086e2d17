"""The dense GQA decoder family (chatglm3-6b) in PyTorch."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.registry import (Model, load_config,  # noqa: F401
                                         load_reduced)
