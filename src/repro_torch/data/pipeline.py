"""Deterministic, checkpointable data pipeline (mirrors
src/repro/data/pipeline.py; the numpy generators are the reference's,
byte for byte).

``SyntheticLM`` generates a learnable affine-Markov token stream: the
cursor is just the step number, so a restart from a checkpoint replays
the same batches.  ``token_file_reader`` is the file-backed path (a
memmap of uint16/uint32 tokens) with the same cursor semantics.
``make_batch_for`` puts a batch on the model's device (int32, as the
reference's), with the encoder-decoder's and the patch frontend's
modality stubs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05            # fraction of non-Markov tokens
    mult: int = 31                 # affine map: next = (mult*t + 7) % vocab


class SyntheticLM:
    """Learnable synthetic LM stream; batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed << 32) ^ step)
        b, s = c.global_batch, c.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, c.vocab, size=b)
        noise = rng.random((b, s)) < c.noise
        rand = rng.integers(0, c.vocab, size=(b, s))
        for t in range(s):
            nxt = (toks[:, t] * c.mult + 7) % c.vocab
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def token_file_reader(path: str, seq_len: int, global_batch: int,
                      dtype=np.uint16):
    """Memmap token-file reader; cursor = step (deterministic restart).
    Returns (batch(step), n_steps)."""
    data = np.memmap(path, dtype=dtype, mode="r")
    per_batch = seq_len * global_batch + 1
    n_steps = (len(data) - 1) // (seq_len * global_batch)

    def batch(step: int) -> Dict[str, np.ndarray]:
        ofs = (step % n_steps) * seq_len * global_batch
        chunk = np.asarray(data[ofs: ofs + per_batch], np.int32)
        toks = chunk[:-1].reshape(global_batch, seq_len)
        labs = chunk[1:].reshape(global_batch, seq_len)
        return {"tokens": toks, "labels": labs}

    return batch, n_steps


def make_batch_for(cfg: ModelConfig, data: Dict[str, np.ndarray],
                   prefix_rng: Optional[np.random.Generator] = None, *,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """A raw token batch as the arch's input dict on ``device`` (the card
    unless the caller asks for the CPU), with the reference's modality
    stubs: an encoder-decoder gets ``frames`` (B, S, d_model) and a patch
    frontend ``prefix_embeds`` (B, prefix_len, d_model), N(0, 1) x 0.02 in
    f32 drawn from ``prefix_rng`` (a fresh ``default_rng(0)`` when none is
    given, so every batch then carries the same stub, as in the
    reference), the patch frontend's labels prefixed by ``prefix_len``
    entries of -1.  Tokens and labels are int32."""
    b, s = data["tokens"].shape
    out = {k: np.asarray(data[k], np.int32) for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        rng = prefix_rng or np.random.default_rng(0)
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32) * 0.02
    elif cfg.frontend == "patch" and cfg.prefix_len:
        rng = prefix_rng or np.random.default_rng(0)
        out["prefix_embeds"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32) * 0.02
        out["labels"] = np.concatenate(
            [np.full((b, cfg.prefix_len), -1, np.int32), out["labels"]],
            axis=1)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}
