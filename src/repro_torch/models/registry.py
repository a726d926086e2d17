"""Architecture registry and the ``Model`` surface the serving engine calls
(mirrors src/repro/models/registry.py for the dense decoder family)."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models import decoder
from repro_torch.models.config import ModelConfig

ARCH_IDS = ("chatglm3_6b",)


def _config_module(arch: str):
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port serves "
                         f"{list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def load_config(arch: str, **overrides) -> ModelConfig:
    cfg = _config_module(arch).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def load_reduced(arch: str, **overrides) -> ModelConfig:
    """Reduced config for CPU tests (f32, as the reference's)."""
    cfg = _config_module(arch).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


class Model:
    """One config on one device: the functions the engine calls."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "decoder":
            raise NotImplementedError(
                f"{cfg.name}: the port covers the dense decoder family")
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, seed: int = 0, quantize: bool = False):
        return decoder.init(self.cfg, seed=seed, device=self.device,
                            quantize=quantize)

    def quantize_weights(self, params):
        return decoder.quantize_weights(params, self.cfg)

    def supports_paged(self) -> bool:
        return self.cfg.family == "decoder"

    def init_paged_cache(self, num_pages: int, page_size: int):
        return decoder.init_paged_cache(self.cfg, num_pages, page_size,
                                        self.device)

    def forward(self, params, tokens):
        return decoder.forward(params, tokens, self.cfg)

    def init_cache(self, batch: int, max_len: int):
        return decoder.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, tokens, *, max_len: int):
        return decoder.prefill(params, tokens, self.cfg, max_len=max_len)

    def decode_step(self, params, token, cache, pos: int):
        return decoder.decode_step(params, token, cache, pos, self.cfg)

    def scatter_prefill(self, pool, cache, page_ids):
        return decoder.scatter_prefill(self.cfg, pool, cache, page_ids)

    def paged_decode_multi_step(self, params, token, pool, block_tables,
                                lengths, remaining, *, n_steps: int,
                                trash_page: int = 0):
        return decoder.paged_decode_multi_step(
            params, token, pool, block_tables, lengths, remaining, self.cfg,
            n_steps=n_steps, trash_page=trash_page)
