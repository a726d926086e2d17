"""Architecture registry and the ``Model`` surface the serving engine calls
(mirrors src/repro/models/registry.py for the GQA decoder family, dense
and MoE)."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models import decoder
from repro_torch.models.config import (ModelConfig,  # noqa: F401
                                       apply_policy_table)

ARCH_IDS = ("chatglm3_6b", "glm4_9b", "yi_34b", "deepseek_67b",
            "moonshot_v1_16b_a3b")

# the reference's other archs, each with the ROADMAP item that ports it
NOT_PORTED = {
    "deepseek_v2_236b": "A7 (MLA attention: mla_attention / mla_decode)",
    "internvl2_76b": "A3 (the patch frontend and prefix_embeds)",
    "zamba2_1p2b": "A10 (the hybrid SSM family)",
    "rwkv6_7b": "A10 (the RWKV family)",
    "seamless_m4t_medium": "A10 (the encoder-decoder family)",
}

# batch inputs of the reference's other families
_UNPORTED_INPUTS = {
    "prefix_embeds": "A3 (the patch frontend and prefix_embeds)",
    "frames": "A10 (the encoder-decoder family)",
}


def _config_module(arch: str):
    arch = arch.replace("-", "_").replace(".", "p")
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP item {NOT_PORTED[arch]}; "
            f"the port serves {list(ARCH_IDS)}")
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
                f"{cfg.name}: the port covers the GQA decoder family")
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, seed: int = 0, quantize: bool = False):
        return decoder.init(self.cfg, seed=seed, device=self.device,
                            quantize=quantize)

    def quantize_weights(self, params):
        return decoder.quantize_weights(params, self.cfg)

    def supports_paged(self) -> bool:
        """As the reference's: a GQA decoder (no MLA, no modality
        frontend; neither field is ported, so every ported config)."""
        return self.cfg.family == "decoder"

    def init_paged_cache(self, num_pages: int, page_size: int):
        return decoder.init_paged_cache(self.cfg, num_pages, page_size,
                                        self.device)

    def forward(self, params, batch, *, fake_quant: bool = False):
        """Training forward (the reference's): ``batch["tokens"]`` (B, S)
        -> (logits (B, S, Vp) f32, MoE aux loss); see decoder.forward.
        A batch of another family's inputs raises, naming the ROADMAP
        item that ports it."""
        for key, item in _UNPORTED_INPUTS.items():
            if key in batch:
                raise NotImplementedError(
                    f"{self.cfg.name}: batch input {key!r} needs ROADMAP "
                    f"item {item}; the port trains the GQA decoder family")
        return decoder.forward(params, batch["tokens"], self.cfg,
                               fake_quant=fake_quant)

    def forward_calib(self, params, tokens):
        """Instrumented forward for ``repro_torch.calib``: (logits, aux,
        taps) with per-layer activation / kv_key / kv_value tensors (see
        decoder.forward_calib)."""
        return decoder.forward_calib(params, tokens, self.cfg)

    def init_cache(self, batch: int, max_len: int):
        return decoder.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, tokens, *, max_len: int, cache=None):
        return decoder.prefill(params, tokens, self.cfg, max_len=max_len,
                               cache=cache)

    def decode_step(self, params, token, cache, pos):
        return decoder.decode_step(params, token, cache, pos, self.cfg)

    def scatter_prefill(self, pool, cache, page_ids):
        return decoder.scatter_prefill(self.cfg, pool, cache, page_ids)

    def paged_prefill_suffix(self, params, tokens, starts, prompt_lens,
                             pool, block_tables):
        """Prefill only the uncached suffix of G prompts over the paged
        pool (prefix sharing; see decoder.paged_prefill_suffix)."""
        return decoder.paged_prefill_suffix(
            params, tokens, starts, prompt_lens, pool, block_tables,
            self.cfg)

    def copy_pool_pages(self, pool, src, dst):
        """Copy page contents src[i] -> dst[i] in every pool leaf (COW)."""
        return decoder.copy_pool_pages(pool, src, dst)

    def paged_decode_window_step(self, params, token, pool, block_tables,
                                 lengths, remaining, keys, **kw):
        return decoder.paged_decode_window_step(
            params, token, pool, block_tables, lengths, remaining, keys,
            self.cfg, **kw)

    def paged_decode_multi_step(self, params, token, pool, block_tables,
                                lengths, remaining, keys, *, n_steps: int,
                                **kw):
        return decoder.paged_decode_multi_step(
            params, token, pool, block_tables, lengths, remaining, keys,
            self.cfg, n_steps=n_steps, **kw)
