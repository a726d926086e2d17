"""Architecture registry and the ``Model`` surface the engines call
(mirrors src/repro/models/registry.py): every family of the reference —
the decoder (GQA, MoE, MLA, the patch frontend), the encoder-decoder,
the Mamba2 hybrid and RWKV6."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import decoder, encdec, hybrid, rwkv_model
from repro_torch.models.config import (ModelConfig,  # noqa: F401
                                       apply_policy_table)

ARCH_IDS = (
    "internvl2_76b", "seamless_m4t_medium", "chatglm3_6b", "yi_34b",
    "deepseek_67b", "glm4_9b", "zamba2_1p2b", "deepseek_v2_236b",
    "moonshot_v1_16b_a3b", "rwkv6_7b",
)

_FAMILY = {"decoder": decoder, "encdec": encdec, "hybrid": hybrid,
           "rwkv": rwkv_model}


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


def family_module(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def make_concrete_batch(cfg: ModelConfig, b: int, s: int,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """A small real batch as numpy arrays from ``seed``, shaped as the
    reference's ``make_concrete_batch``: an encoder-decoder gets ``frames``
    (b, max(2, s // 2), d) f32 and that many decoder tokens; a patch
    frontend ``prefix_embeds`` (b, prefix_len, d) f32 and max(2, s -
    prefix_len) tokens (labels cover the prefix too); otherwise (b, s)
    tokens.  Embeddings are N(0, 1)."""
    rng = np.random.default_rng(seed)
    d, v = cfg.d_model, cfg.vocab

    def ints(shape):
        return rng.integers(0, v, size=shape).astype(np.int32)

    if cfg.family == "encdec":
        half = max(2, s // 2)
        return {"frames": rng.standard_normal((b, half, d), np.float32),
                "tokens": ints((b, half)), "labels": ints((b, half))}
    if cfg.frontend == "patch" and cfg.prefix_len:
        st = max(2, s - cfg.prefix_len)
        return {"prefix_embeds": rng.standard_normal(
                    (b, cfg.prefix_len, d), np.float32),
                "tokens": ints((b, st)),
                "labels": ints((b, st + cfg.prefix_len))}
    return {"tokens": ints((b, s)), "labels": ints((b, s))}


# =============================================================================
# input specs (tensors on the meta device: shapes and dtypes, no storage)
# =============================================================================
def batch_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    """Training / prefill batch stand-ins of one (arch x shape) cell (the
    reference's ``batch_specs``): meta tensors of its shapes and
    dtypes."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dtype=i32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.family == "encdec":
        se, sd = s // 2, s // 2
        return {"frames": spec((b, se, cfg.d_model), torch.bfloat16),
                "tokens": spec((b, sd)), "labels": spec((b, sd))}
    if cfg.frontend == "patch" and cfg.prefix_len:
        st = s - cfg.prefix_len
        return {"prefix_embeds": spec((b, cfg.prefix_len, cfg.d_model),
                                      torch.bfloat16),
                "tokens": spec((b, st)),
                "labels": spec((b, st + cfg.prefix_len))}
    return {"tokens": spec((b, s)), "labels": spec((b, s))}


def decode_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """Decode-step stand-ins (the reference's ``decode_specs``): one new
    token against a ``seq_len``-deep cache, in the port's cache layout
    (``Model.init_cache`` on the meta device)."""
    b, s = shape.global_batch, shape.seq_len
    s_enc = s // 2 if cfg.family == "encdec" else 0
    max_len = s // 2 if cfg.family == "encdec" else s
    cache = Model(cfg, device="meta").init_cache(b, max_len, s_enc)
    return {"token": torch.empty((b,), dtype=torch.int32, device="meta"),
            "cache": cache,
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


class Model:
    """One config on one device: the functions the engines call, one
    surface over every family (the reference's signatures, with the
    caches and states written in place)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.mod = family_module(cfg)
        self.device = torch.device(device)

    def _refuse_unless_decoder(self, what: str) -> None:
        if self.cfg.family != "decoder":
            raise NotImplementedError(
                f"{self.cfg.name}: {what} covers the decoder family")

    def init(self, seed: int = 0, quantize: bool = False, place=None):
        """Random weights from ``seed`` (weight-resident MX storage with
        ``quantize``); ``place`` (the decoder family) keeps a sharded
        rank's shard of each piece as it is made."""
        if self.cfg.family == "decoder":
            return decoder.init(self.cfg, seed=seed, device=self.device,
                                quantize=quantize, place=place)
        if place is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: sharded weights cover the decoder "
                f"family")
        if quantize:
            self._refuse_unless_decoder("weight-resident storage")
        return self.mod.init(self.cfg, seed=seed, device=self.device)

    def quantize_weights(self, params):
        """Weight-resident MXWeight storage per the policy's ``weights``
        role: the GQA decoder family (MLA refuses, as in the
        reference)."""
        self._refuse_unless_decoder("weight-resident storage")
        return decoder.quantize_weights(params, self.cfg)

    def supports_paged(self) -> bool:
        """As the reference's: a GQA decoder with no MLA and no modality
        frontend."""
        cfg = self.cfg
        return (cfg.family == "decoder" and not cfg.mla
                and cfg.frontend == "none")

    def init_paged_cache(self, num_pages: int, page_size: int):
        if not self.supports_paged():
            raise NotImplementedError(
                f"{self.cfg.name}: paged KV serving needs a GQA decoder")
        return decoder.init_paged_cache(self.cfg, num_pages, page_size,
                                        self.device)

    def forward(self, params, batch, *, fake_quant: bool = False):
        """Training forward (the reference's): the family's inputs of
        ``batch`` -> (logits (B, S, Vp) f32, MoE aux loss)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.forward(params, batch["frames"], batch["tokens"],
                                  cfg, fake_quant=fake_quant)
        if cfg.family == "decoder":
            return decoder.forward(params, batch["tokens"], cfg,
                                   prefix_embeds=batch.get("prefix_embeds"),
                                   fake_quant=fake_quant)
        return self.mod.forward(params, batch["tokens"], cfg,
                                fake_quant=fake_quant)

    def forward_calib(self, params, tokens):
        """Instrumented forward for ``repro_torch.calib``: (logits, aux,
        taps) with per-layer activation / kv_key / kv_value tensors (the
        GQA decoder family; see decoder.forward_calib)."""
        self._refuse_unless_decoder("calibration taps")
        return decoder.forward_calib(params, tokens, self.cfg)

    def init_cache(self, batch: int, max_len: int, s_enc: int = 0):
        """The static engine's cache (an encoder-decoder's cross K/V is
        ``s_enc`` long)."""
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, batch, max_len, s_enc,
                                     self.device)
        return self.mod.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, batch, *, max_len: int, cache=None):
        """Prefill the reference's batch dict (``tokens``, and ``frames``
        or ``prefix_embeds``; a bare token tensor is ``{"tokens": it}``)
        into ``cache`` (filled in place) or a new one; returns (logits,
        cache, the next position)."""
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        cfg, dev = self.cfg, self.device
        tokens = _on(batch["tokens"], dev)
        if cfg.family == "encdec":
            return encdec.prefill(params, _on(batch["frames"], dev), tokens,
                                  cfg, max_len=max_len, cache=cache)
        if cfg.family == "decoder":
            pe = batch.get("prefix_embeds")
            return decoder.prefill(params, tokens, cfg, max_len=max_len,
                                   prefix_embeds=None if pe is None
                                   else _on(pe, dev), cache=cache)
        return self.mod.prefill(params, tokens, cfg, max_len=max_len,
                                cache=cache)

    def decode_step(self, params, token, cache, pos):
        return self.mod.decode_step(params, token, cache, pos, self.cfg)

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
